"""flatten_span_s (s): the flatten layer (``api._flatten_state``,
``query.DeviceIndex.from_prepare``) timed where it runs:
``BuildReport.t_flatten`` per build, from the end of the prepare stage to
``ell_host`` on the host, the interval of the program's ``build/flatten``
span.  With ``text_s`` it names what ``flatten_s`` takes as a remainder.
Only index builds flatten; a program without that timer reports
nothing."""

from erabench.metrics._per_build import mean


def read(run):
    if (run.cell.traffic["entry"] not in ("build_device", "build_stream")
            or not run.builds
            or not hasattr(run.builds[0].record["report"], "t_flatten")):
        return None
    return mean(run, lambda b: b.record["report"].t_flatten)

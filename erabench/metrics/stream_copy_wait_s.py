"""stream_copy_wait_s (s): the out-of-core layer's blocking wait for
host-to-device state copies per build (``StreamReport.copy_wait_s``)."""

from erabench.metrics._per_build import mean


def read(run):
    if not run.builds or "stream" not in run.builds[0].record:
        return None
    return mean(run, lambda b: b.record["stream"].copy_wait_s)

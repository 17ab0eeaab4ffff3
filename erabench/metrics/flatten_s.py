"""flatten_s (s): the flatten layer (``api._flatten_state``,
``DeviceIndex.from_prepare``) per build: the build's wall less
``t_vertical`` and ``t_prepare``.  Only index builds flatten."""

from erabench.metrics._per_build import mean


def read(run):
    if run.cell.traffic["entry"] not in ("build_device", "build_stream"):
        return None
    return mean(run, lambda b: b.wall_s - b.record["report"].t_vertical
                - b.record["report"].t_prepare)

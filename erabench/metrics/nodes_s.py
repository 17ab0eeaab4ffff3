"""nodes_s (s): the node-build layer (``api._attach_nodes_batched`` ->
``core/build.py``), ``BuildReport.t_build`` per build.  Only tree builds
build nodes."""

from erabench.metrics._per_build import mean


def read(run):
    if run.cell.traffic["entry"] != "build_tree":
        return None
    return mean(run, lambda b: b.record["report"].t_build)

"""slice_s (s): the tree build's host slicing (``api._HostState`` and the
``_slice_subtrees`` loop): the final prepare state read to the host and
cut into sub-trees, ``BuildReport.t_slice`` per build, the interval of
the program's ``build/slice`` span.  It is a part of ``prepare_s``.  Only
tree builds slice; a program without that timer reports nothing."""

from erabench.metrics._per_build import mean


def read(run):
    if (run.cell.traffic["entry"] != "build_tree" or not run.builds
            or not hasattr(run.builds[0].record["report"], "t_slice")):
        return None
    return mean(run, lambda b: b.record["report"].t_slice)

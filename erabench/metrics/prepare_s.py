"""prepare_s (s): the prepare layer (``core/prepare.py``, the elastic-range
loop), ``BuildReport.t_prepare`` per build.  In ``EraIndexer.build`` (the
tree cell) the program's timer also holds the host slicing of the
sub-trees out of the final state, so there it measures more than the
loop."""

from erabench.metrics._per_build import mean


def read(run):
    return mean(run, lambda b: b.record["report"].t_prepare)

"""vertical_s (s): the partition layer (``core/vertical.py``, the
``kmer_histogram`` kernel), ``BuildReport.t_vertical`` per build."""

from erabench.metrics._per_build import mean


def read(run):
    return mean(run, lambda b: b.record["report"].t_vertical)

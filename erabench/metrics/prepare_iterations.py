"""prepare_iterations (count): elastic-range iterations of the prepare
layer per build (``PrepareStats.iterations``, summed over a streamed
build's chunks)."""

from erabench.metrics._per_build import mean


def read(run):
    return mean(run, lambda b: b.record["report"].prepare.iterations)

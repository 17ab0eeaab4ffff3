"""to_host_gib (GiB): bytes a build copies from the device to the host,
``BuildReport.bytes_to_host`` / 2^30 per build: every such copy in the
partition, the prepare stage, the stream, the slicing, the node build and
the flatten whose size grows with the string or the number of sub-trees.
A scalar or a vector of G entries read back (the prepare loop's
per-iteration active counts, already counted by ``prepare_iterations``)
is left out.  Counted from shapes: no device read.  A program without
the counter reports nothing."""

from erabench.metrics._per_build import mean


def read(run):
    if not run.builds or not hasattr(run.builds[0].record["report"],
                                     "bytes_to_host"):
        return None
    return mean(run, lambda b: b.record["report"].bytes_to_host / 2**30)

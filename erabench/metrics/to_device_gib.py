"""to_device_gib (GiB): bytes a build copies from the host to the device,
``BuildReport.bytes_to_device`` / 2^30 per build: the string for the
partition, the construction text, the stream's chunk states, the node
rows' index and mask, the index's tables and served text, and every
other such copy whose size grows with the string or the number of
sub-trees (a scalar or a vector of G entries is left out).  Counted from
shapes: no device read.  A program without the counter reports
nothing."""

from erabench.metrics._per_build import mean


def read(run):
    if not run.builds or not hasattr(run.builds[0].record["report"],
                                     "bytes_to_device"):
        return None
    return mean(run, lambda b: b.record["report"].bytes_to_device / 2**30)

"""kernels_roofline_pct (%): the port's build kernels in the traced window,
their least time over their time: the sum of each launch's bound (the
frozen work formulas of :mod:`erabench.work` at the launch's shapes,
against 3.35 TB/s and 67 T int32 op/s of one H100 SXM at 700 W) over the
sum of their device milliseconds.

Every launch must have been seen: where the launches the taps saw differ
from the program's own count (``ops.launch_counts()``) the reading is
rejected and the metric left out.  A kernel's milliseconds are the
profiler's where its calls equal the launches, else the CUDA events around
its launches (the profiler has dropped launches on this card)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.kernels:
        return None
    bound = spent = 0.0
    for row in tr.kernels.values():
        if row["launches"] != row["counted"]:
            return None
        ms = (row["profiler_ms"] if row["profiler_calls"] == row["launches"]
              else row["event_ms"])
        bound += row["bound_ms"]
        spent += ms
    if spent <= 0:
        return None
    return 100.0 * bound / spent

"""Metric readers, one file per metric of ``BENCHMARK.json``, found by the
metric's name: ``read(run)`` takes a :class:`erabench.harness.Run` and
returns the value, or None where it finds nothing to read (the harness
then leaves the metric out of the line)."""

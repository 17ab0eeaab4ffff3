"""repro_torch.obs — the port's zero-dependency flight recorder.

The PyTorch port's own copy of ``repro.obs`` (standard library only; the
port imports nothing of the JAX package): one process-global
:class:`~repro_torch.obs.trace.Tracer` and one
:class:`~repro_torch.obs.metrics.Metrics` registry, both OFF by default and
gated on env knobs following the ``REPRO_SERVE_*`` idiom:

* ``REPRO_TRACE=1``    — record spans (ring buffer; Chrome/Perfetto +
  JSONL exporters).  ``REPRO_TRACE_OUT`` overrides the default export
  path (``era_trace.json``).
* ``REPRO_METRICS=1``  — record counters/gauges/histograms (JSON +
  Prometheus-text exporters).  ``REPRO_METRICS_OUT`` overrides the
  default export path (``era_metrics.prom``).

Overhead budget (the contract instrumented hot paths rely on): with the
knobs unset, ``tracer().span(...)`` is an attribute check returning the
shared null span and ``metrics().counter(...)`` returns the shared null
instrument — a dict-lookup-and-no-op ceiling, verified by
``tests/test_torch_obs.py`` and the ``trace`` phase of ``chip_smoke.py``
(recorder-on qps at least half the recorder-off qps on the card).

Enablement is resolved when an instrument is CREATED: call
:func:`configure` (tests, smoke drivers) before building the objects you
want instrumented — instruments bound while a registry was disabled stay
null.  Processes driven purely by the env knobs never notice (the knobs
are fixed at startup).

Usage:

    from repro_torch import obs
    with obs.tracer().span("serve/pad_pack", rows=8):
        ...
    obs.metrics().counter("serve_batches_total").inc()
    obs.export_all()          # writes trace + metrics files when enabled
"""

from __future__ import annotations

import os
import threading

from repro_torch.obs.metrics import (  # noqa: F401  (re-exported)
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    Metrics,
    NULL_INSTRUMENT,
    pow2_buckets,
)
from repro_torch.obs.trace import (  # noqa: F401  (re-exported)
    NULL_SPAN,
    Tracer,
    validate_chrome_trace,
)

_lock = threading.Lock()
_tracer: Tracer | None = None
_metrics: Metrics | None = None


def tracer() -> Tracer:
    """The process-global tracer (created on first use from the env)."""
    global _tracer
    if _tracer is None:
        with _lock:
            if _tracer is None:
                _tracer = Tracer()
    return _tracer


def metrics() -> Metrics:
    """The process-global metrics registry (created on first use)."""
    global _metrics
    if _metrics is None:
        with _lock:
            if _metrics is None:
                _metrics = Metrics()
    return _metrics


def trace_enabled() -> bool:
    return tracer().enabled


def metrics_enabled() -> bool:
    return metrics().enabled


def configure(trace: bool | None = None, metrics_on: bool | None = None,
              clear: bool = False) -> None:
    """Programmatic override of the env gating (tests / smoke drivers).

    ``trace`` / ``metrics_on``: True/False to force, None to leave as-is.
    ``clear`` drops recorded spans and registered instruments first.
    Instruments already bound by callers keep their old (possibly null)
    identity — flip BEFORE constructing what you want observed.
    """
    t, m = tracer(), metrics()
    if clear:
        t.clear()
        m.clear()
    if trace is not None:
        t.enabled = bool(trace)
    if metrics_on is not None:
        m.enabled = bool(metrics_on)


def export_all(trace_path: str | None = None,
               metrics_path: str | None = None) -> list[str]:
    """Write every enabled exporter's artifact; returns the paths written.

    Defaults honor ``REPRO_TRACE_OUT`` / ``REPRO_METRICS_OUT``; a
    disabled layer writes nothing (so drivers can call this
    unconditionally at exit).
    """
    written: list[str] = []
    t, m = tracer(), metrics()
    if t.enabled:
        path = trace_path or os.environ.get("REPRO_TRACE_OUT",
                                            "era_trace.json")
        written.append(t.write_chrome(path))
    if m.enabled:
        path = metrics_path or os.environ.get("REPRO_METRICS_OUT",
                                              "era_metrics.prom")
        written.append(m.write_prometheus(path))
    return written

"""Metrics registry: counters, gauges, fixed-bucket histograms + exporters
(the port's copy of ``repro.obs.metrics``; the exposition text is the
same byte for byte).

The :class:`Metrics` registry hands out three instrument kinds, each
addressed by ``(name, labels)`` — repeated registration returns the SAME
instrument (one dict lookup), so hot paths may either re-fetch per call
or bind once at init:

* :class:`Counter`   — monotonic float total (``inc``);
* :class:`Gauge`     — last-set value (``set``/``inc``/``dec``), or a
  *callback* gauge whose value is computed at snapshot time (wire a
  cache's ``hit_rate`` or a queue's ``len`` without polling);
* :class:`Histogram` — fixed upper-bound buckets with total sum/count;
  p50/p99 (any quantile) are derived host-side by linear interpolation
  inside the owning bucket.

Two exporters: :meth:`Metrics.snapshot` (plain JSON-able dict, histograms
carry derived p50/p99) and :meth:`Metrics.to_prometheus` (the Prometheus
text exposition format — counters get ``# TYPE``/``# HELP`` headers,
histograms expand to cumulative ``_bucket{le=...}`` series + ``_sum`` /
``_count``).

Thread safety: every mutation takes the instrument's lock (the async
serving loop and any worker threads may hammer one counter concurrently);
snapshots lock per instrument, so they are consistent per instrument and
lock-free across the registry.

Overhead contract: a disabled registry's ``counter``/``gauge``/
``histogram`` return the shared null instruments — one method call
returning a constant; ``inc``/``observe`` on them are empty methods.

Enable with ``REPRO_METRICS=1`` or via :func:`repro_torch.obs.configure`.
"""

from __future__ import annotations

import json
import math
import os
import threading

# default histogram buckets: latency-ish spread in ms (callers pass their
# own for anything that is not a millisecond latency)
DEFAULT_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                   100.0, 250.0, 1000.0)


class _NullInstrument:
    """Shared no-op counter/gauge/histogram for the disabled registry."""

    __slots__ = ()

    def inc(self, n=1) -> None:
        pass

    def dec(self, n=1) -> None:
        pass

    def set(self, v) -> None:
        pass

    def observe(self, v) -> None:
        pass

    @property
    def value(self) -> float:
        return 0.0

    @property
    def count(self) -> int:
        return 0

    @property
    def sum(self) -> float:
        return 0.0

    def percentile(self, q) -> float:
        return 0.0


NULL_INSTRUMENT = _NullInstrument()


class Counter:
    """Monotonic total.  ``inc`` with a negative amount raises — use a
    Gauge for values that go down."""

    kind = "counter"
    __slots__ = ("name", "help", "labels", "_value", "_lock")

    def __init__(self, name: str, help: str = "", labels: dict | None = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: inc({n}) must be >= 0")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-set value, or a zero-arg callback evaluated at snapshot time."""

    kind = "gauge"
    __slots__ = ("name", "help", "labels", "_value", "_fn", "_lock")

    def __init__(self, name: str, help: str = "", labels: dict | None = None,
                 fn=None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._value = 0.0
        self._fn = fn
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:
                return float("nan")
        return self._value


class Histogram:
    """Fixed-bucket histogram: ``buckets`` are sorted upper bounds; one
    implicit +Inf bucket catches the tail.  Quantiles interpolate
    linearly inside the owning bucket (the +Inf bucket clamps to the last
    finite bound), so accuracy is the bucket resolution — pick buckets to
    match the scale you care about."""

    kind = "histogram"
    __slots__ = ("name", "help", "labels", "buckets", "_counts", "_sum",
                 "_count", "_lock")

    def __init__(self, name: str, buckets=DEFAULT_BUCKETS, help: str = "",
                 labels: dict | None = None):
        bounds = tuple(float(b) for b in buckets)
        if not bounds or list(bounds) != sorted(set(bounds)):
            raise ValueError(
                f"histogram {name}: buckets must be sorted, unique, "
                f"non-empty (got {buckets!r})")
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.buckets = bounds
        self._counts = [0] * (len(bounds) + 1)  # [..., +Inf]
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        i = _bisect(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def bucket_counts(self) -> list[int]:
        with self._lock:
            return list(self._counts)

    def percentile(self, q: float) -> float:
        """The q-th percentile (q in [0, 100]), interpolated within the
        owning bucket.  Returns nan when nothing was observed."""
        if not 0 <= q <= 100:
            raise ValueError(f"q={q} must be in [0, 100]")
        with self._lock:
            counts = list(self._counts)
            total = self._count
        if total == 0:
            return float("nan")
        rank = q / 100.0 * total
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= rank and c > 0:
                lo = 0.0 if i == 0 else self.buckets[i - 1]
                hi = self.buckets[min(i, len(self.buckets) - 1)]
                if i >= len(self.buckets):
                    return self.buckets[-1]  # +Inf bucket clamps
                frac = (rank - (cum - c)) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        return self.buckets[-1]


def _bisect(bounds, v) -> int:
    lo, hi = 0, len(bounds)
    while lo < hi:
        mid = (lo + hi) // 2
        if v <= bounds[mid]:
            hi = mid
        else:
            lo = mid + 1
    return lo


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _escape(v) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


class Metrics:
    """The instrument registry.  ``enabled=None`` reads ``REPRO_METRICS``."""

    def __init__(self, enabled: bool | None = None):
        if enabled is None:
            enabled = os.environ.get("REPRO_METRICS", "0") not in ("", "0")
        self.enabled = bool(enabled)
        self._by_key: dict[tuple, object] = {}
        self._kinds: dict[str, str] = {}     # name -> kind (conflict guard)
        self._lock = threading.Lock()

    # ---- registration (idempotent; a dict lookup on repeat calls) ---------

    def _get(self, cls, name: str, help: str, labels: dict, **kwargs):
        if not self.enabled:
            return NULL_INSTRUMENT
        key = (name, _label_key(labels))
        inst = self._by_key.get(key)
        if inst is not None:
            if inst.kind != cls.kind:
                raise ValueError(
                    f"metric {name!r} already registered as a {inst.kind}, "
                    f"cannot re-register as a {cls.kind}")
            return inst
        with self._lock:
            inst = self._by_key.get(key)
            if inst is not None:
                if inst.kind != cls.kind:
                    raise ValueError(
                        f"metric {name!r} already registered as a "
                        f"{inst.kind}, cannot re-register as a {cls.kind}")
                return inst
            kind = self._kinds.get(name)
            if kind is not None and kind != cls.kind:
                raise ValueError(
                    f"metric {name!r} already registered as a {kind}, "
                    f"cannot re-register as a {cls.kind}")
            inst = cls(name, help=help, labels=labels, **kwargs)
            self._kinds[name] = cls.kind
            self._by_key[key] = inst
            return inst

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", fn=None, **labels) -> Gauge:
        g = self._get(Gauge, name, help, labels, fn=fn)
        if fn is not None and isinstance(g, Gauge):
            g._fn = fn  # re-registration rebinds the callback (newest wins)
        return g

    def histogram(self, name: str, buckets=DEFAULT_BUCKETS, help: str = "",
                  **labels) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def instruments(self) -> list:
        with self._lock:
            return list(self._by_key.values())

    def clear(self) -> None:
        with self._lock:
            self._by_key.clear()
            self._kinds.clear()

    # ---- exporters --------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able view: per-instrument values, histograms with derived
        p50/p99 (derived on the host)."""
        out: dict[str, list] = {"counters": [], "gauges": [], "histograms": []}
        for inst in self.instruments():
            entry = {"name": inst.name, "labels": dict(inst.labels)}
            if inst.kind == "counter":
                entry["value"] = inst.value
                out["counters"].append(entry)
            elif inst.kind == "gauge":
                val = inst.value
                entry["value"] = None if math.isnan(val) else val
                out["gauges"].append(entry)
            else:
                entry.update(
                    count=inst.count, sum=inst.sum,
                    buckets=list(inst.buckets),
                    bucket_counts=inst.bucket_counts(),
                    p50=_nan_none(inst.percentile(50)),
                    p99=_nan_none(inst.percentile(99)),
                )
                out["histograms"].append(entry)
        return out

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), indent=2, sort_keys=True)

    def to_prometheus(self) -> str:
        """The Prometheus text exposition format (0.0.4)."""
        lines: list[str] = []
        seen_header: set[str] = set()
        for inst in sorted(self.instruments(),
                           key=lambda i: (i.name, _label_key(i.labels))):
            if inst.name not in seen_header:
                seen_header.add(inst.name)
                if inst.help:
                    lines.append(f"# HELP {inst.name} {inst.help}")
                lines.append(f"# TYPE {inst.name} {inst.kind}")
            if inst.kind in ("counter", "gauge"):
                val = inst.value
                if isinstance(val, float) and math.isnan(val):
                    val = "NaN"
                lines.append(f"{inst.name}{_label_str(inst.labels)} {val}")
            else:
                counts = inst.bucket_counts()
                cum = 0
                for bound, c in zip(inst.buckets, counts):
                    cum += c
                    labels = dict(inst.labels, le=_fmt_bound(bound))
                    lines.append(
                        f"{inst.name}_bucket{_label_str(labels)} {cum}")
                cum += counts[-1]
                labels = dict(inst.labels, le="+Inf")
                lines.append(f"{inst.name}_bucket{_label_str(labels)} {cum}")
                ls = _label_str(inst.labels)
                lines.append(f"{inst.name}_sum{ls} {inst.sum}")
                lines.append(f"{inst.name}_count{ls} {inst.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def write_prometheus(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_prometheus())
        return path

    def write_json(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
        return path


def _fmt_bound(b: float) -> str:
    return str(int(b)) if float(b).is_integer() else repr(b)


def _nan_none(v: float):
    return None if math.isnan(v) else v


def pow2_buckets(lo: float, hi: float) -> tuple:
    """Power-of-two bucket bounds from lo to hi inclusive (queue depths,
    batch rows, elastic ranges — anything the code itself buckets pow2)."""
    out = []
    b = float(lo)
    while b < hi:
        out.append(b)
        b *= 2
    out.append(float(hi))
    return tuple(out)

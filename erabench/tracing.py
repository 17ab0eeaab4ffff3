"""The traced run's readings: the card's activity from ``torch.profiler``,
each launch of the port's build kernels with its shapes, and the host
spans of ``repro_torch.obs``.

* :class:`KernelTaps` wraps the port's kernel functions where the program
  calls them (attributes of ``repro_torch.kernels.ops``) for the window:
  each call that launched (its ``launches`` count rose) leaves its work
  from :mod:`erabench.work` at the call's shapes and a pair of CUDA events.
* :class:`DeviceTrace` profiles the window's device activity (kernels,
  copies, sets; no host ops, no chrome trace), and aligns the device's
  clock to the host's by a marker launched right after a synchronize.
* :func:`summarize` reduces both, with the spans, to :class:`TraceData`:
  busy seconds (the union of the device intervals inside the window),
  the idle gaps named by the innermost span open on the host at their
  middle, the device time by operation, and per port kernel the
  profiler's milliseconds and calls beside the taps' launches, event
  milliseconds and bound milliseconds.
"""

from __future__ import annotations

import dataclasses
import re
import threading
import time

import numpy as np
import torch

from erabench import work

_CUT = 80  # characters kept of a device operation's name


def _nw(w: int, per_word: int) -> int:
    return -(-int(w) // per_word)


def _work_gather_words(pt, offs, w, *a, **k):
    return work.gather_work(offs.shape[0], _nw(w, pt.syms_per_word),
                            pt.words.shape[0])


def _work_gather_pack(s, offs, w, *a, **k):
    return work.gather_pack_work(offs.shape[0], _nw(w, 4), s.shape[0])


def _work_gather_packed(pt, offs, w, *a, **k):
    return work.gather_packed_work(offs.shape[0], _nw(w, 4), pt.bits,
                                   pt.words.shape[0])


def _work_lcp_pairs(a, b, w, *r, **k):
    return work.lcp_work(a.shape[0], min(a.shape[1], _nw(w, 4)))


def _work_kmer(s, n, k, base, *r, **kw):
    return work.kmer_work(n, k, base)


def _reads(lcp: torch.Tensor, w: int, per_read: int) -> torch.Tensor:
    """Reads each suffix makes up to its first difference (on the card,
    summed there: no host sync inside the window)."""
    return torch.clamp(lcp.to(torch.int64) // per_read + 1,
                       max=_nw(w, per_read)).sum()


# (ops attribute, ops.KERNELS name, work at the call's shapes, deferred
# work of the call's output or None)
TAPS = (
    ("range_gather_words", "range_gather_words", _work_gather_words, None),
    ("range_gather_pack", "range_gather_pack", _work_gather_pack, None),
    ("range_gather_packed", "range_gather_packed", _work_gather_packed, None),
    ("lcp_pairs", "lcp_pairs", _work_lcp_pairs, None),
    ("kmer_histogram", "kmer_histogram", _work_kmer, None),
    ("suffix_lcp_words", "suffix_lcp_words", None,
     lambda out, pt, a, b, w: (a.shape[0], _reads(out, w, pt.syms_per_word),
                               pt.nbytes, 8)),
    ("_suffix_lcp_bytes", "suffix_lcp_pairs", None,
     lambda out, s, a, b, w: (a.shape[0], _reads(out, w, 4), s.shape[0], 8)),
)


class KernelTaps:
    """Context manager: the port's build kernels wrapped for the window."""

    def __init__(self):
        self.launches: list[tuple] = []  # (kernel, work or deferred, e0, e1)
        self._saved: dict = {}
        self.counts0: dict = {}
        self.counts1: dict = {}

    def __enter__(self):
        from repro_torch.kernels import ops
        self._ops = ops
        for attr, name, fn_work, deferred in TAPS:
            fn = getattr(ops, attr)
            self._saved[attr] = fn
            setattr(ops, attr, self._wrap(name, fn, fn_work, deferred))
        self.counts0 = ops.launch_counts()
        return self

    def __exit__(self, *exc):
        self.counts1 = self._ops.launch_counts()
        for attr, fn in self._saved.items():
            setattr(self._ops, attr, fn)
        return False

    def _wrap(self, name, fn, fn_work, deferred):
        def call(*args, **kwargs):
            before = fn.launches
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args, **kwargs)
            e1.record()
            if fn.launches > before:
                w = (deferred(out, *args) if deferred is not None
                     else fn_work(*args, **kwargs))
                self.launches.append((name, w, e0, e1))
            return out
        return call

    def per_kernel(self) -> dict:
        """{kernel: {"launches", "counted", "event_ms", "bound_ms"}} after
        the window; ``counted``: the program's own launch count."""
        out = {}
        for name, w, e0, e1 in self.launches:
            if len(w) == 4:  # deferred suffix-pair LCP work
                pairs, reads, text, per = w
                w = work.suffix_lcp_work(pairs, int(reads), text, per)
            row = out.setdefault(name, {"launches": 0, "event_ms": 0.0,
                                        "bound_ms": 0.0})
            row["launches"] += 1
            row["event_ms"] += e0.elapsed_time(e1)
            row["bound_ms"] += work.bound_ms(*w)
        for name, row in out.items():
            row["counted"] = self.counts1[name] - self.counts0[name]
        for name in self.counts1:
            if name not in out and self.counts1[name] != self.counts0[name]:
                out[name] = {"launches": 0, "event_ms": 0.0, "bound_ms": 0.0,
                             "counted": self.counts1[name] - self.counts0[name]}
        return out


class DeviceTrace:
    """``torch.profiler`` over the window, device activity only."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t_mark_ns = time.perf_counter_ns()
        torch.ones(1, device="cuda").add_(1)  # the marker: first device event
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        return False

    def device_events(self):
        """(name, start_ns, end_ns) of every device event on the host clock,
        and per name its total ms and count.  Read from the profiler's raw
        results: building its per-event objects (``prof.events()``,
        ``key_averages()``) takes minutes for a window of many builds."""
        from torch.autograd import DeviceType
        rows = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                for e in self.prof.profiler.kineto_results.events()
                if e.device_type() != DeviceType.CPU]
        if not rows:
            return [], {}
        t0 = min(r[1] for r in rows)  # the marker's start
        events = [(n, a - t0 + self.t_mark_ns, b - t0 + self.t_mark_ns)
                  for n, a, b in rows]
        avg: dict = {}
        for n, a, b in rows:
            ms, calls = avg.get(n, (0.0, 0))
            avg[n] = (ms + (b - a) / 1e6, calls + 1)
        return events, avg


@dataclasses.dataclass
class TraceData:
    window_s: float
    busy_s: float
    idle_gaps: list      # [[span name, seconds], ...] longest first
    device_ops: list     # [[operation, seconds], ...] longest first
    kernels: dict        # per port kernel, see summarize()
    n_events: int


def kernel_of(name: str, kernels) -> str | None:
    """The port kernel a device event belongs to: the longest kernel name
    that begins the event's function name."""
    m = re.search(r"([A-Za-z_]\w*)\s*[<(]", name)
    base = m.group(1) if m else name
    hits = [k for k in kernels if base.startswith(k)]
    return max(hits, key=len) if hits else None


def _union(starts: np.ndarray, ends: np.ndarray):
    """Merged (starts, ends) of a set of intervals."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > reach[:-1]
    first = np.nonzero(new)[0]
    last = np.append(first[1:], len(s)) - 1
    return s[first], reach[last]


def _innermost(spans: list, t: np.ndarray) -> list:
    """The name of the deepest span that contains each time in ``t``
    (one thread's spans nest, so each depth's spans are disjoint)."""
    names = ["(no span)"] * len(t)
    best = np.full(len(t), -1)
    by_depth: dict = {}
    for name, a, b, d in spans:
        by_depth.setdefault(d, []).append((a, b, name))
    for d, rows in by_depth.items():
        rows.sort()
        a = np.array([r[0] for r in rows])
        b = np.array([r[1] for r in rows])
        i = np.searchsorted(a, t, side="right") - 1
        ok = (i >= 0) & (b[np.maximum(i, 0)] >= t) & (d > best)
        for j in np.nonzero(ok)[0]:
            names[j] = rows[i[j]][2]
            best[j] = d
    return names


def summarize(trace: DeviceTrace, taps: KernelTaps, spans: list,
              t0_ns: int, t1_ns: int, kernel_names) -> TraceData:
    """The window [t0_ns, t1_ns] (host clock) reduced to its readings;
    ``spans``: (name, start_ns, end_ns, depth) of the main thread's host
    spans on the same clock."""
    events, avg = trace.device_events()
    window_s = (t1_ns - t0_ns) / 1e9
    busy_s = 0.0
    gaps: dict = {}
    if events:
        st = np.array([e[1] for e in events], np.int64)
        en = np.array([e[2] for e in events], np.int64)
        st, en = np.clip(st, t0_ns, t1_ns), np.clip(en, t0_ns, t1_ns)
        keep = en > st
        us, ue = _union(st[keep], en[keep]) if keep.any() else (
            np.zeros(0, np.int64), np.zeros(0, np.int64))
        busy_s = float((ue - us).sum()) / 1e9
        g0 = np.concatenate([[t0_ns], ue])
        g1 = np.concatenate([us, [t1_ns]])
        gap = g1 > g0
        g0, g1 = g0[gap], g1[gap]
        for name, a, b in zip(_innermost(spans, (g0 + g1) // 2), g0, g1):
            gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e9
    ops = sorted(((k[:_CUT], ms / 1e3) for k, (ms, _) in avg.items()),
                 key=lambda r: -r[1])
    kernels = taps.per_kernel()
    for row in kernels.values():
        row["profiler_ms"], row["profiler_calls"] = 0.0, 0
    for key, (ms, calls) in avg.items():
        k = kernel_of(key, kernel_names)
        if k in kernels:
            kernels[k]["profiler_ms"] += ms
            kernels[k]["profiler_calls"] += calls
    return TraceData(
        window_s=window_s, busy_s=busy_s,
        idle_gaps=[[k, v] for k, v in sorted(gaps.items(),
                                             key=lambda r: -r[1])[:10]],
        device_ops=[list(r) for r in ops[:10]], kernels=kernels,
        n_events=len(events))


def host_spans(tracer) -> list:
    """(name, start_ns, end_ns, depth) of the calling thread's spans, on
    the ``time.perf_counter_ns`` clock."""
    origin = tracer._t_origin
    me = threading.get_ident()
    return [(e["name"], e["ts_ns"] + origin, e["ts_ns"] + origin + e["dur_ns"],
             e["depth"]) for e in tracer.events()
            if e["ph"] == "X" and e["tid"] == me]

"""Flight-recorder tracing: nestable wall-clock spans in a ring buffer
(the port's copy of ``repro.obs.trace``; the Chrome and JSONL exports are
the same, process names included).

A :class:`Tracer` records *spans* — named wall-clock intervals with
arbitrary key/value attributes — into a lock-protected in-memory ring
buffer (a bounded ``deque``: the recorder never grows without bound, old
spans fall off the back).  Spans nest per thread: the exporters carry a
``depth`` per event and Chrome/Perfetto nests complete events on the same
thread track automatically, so the serving loop's ``serve/pump`` >
``serve/pad_pack`` > ``serve/device_dispatch`` hierarchy renders as a
flame graph with zero extra bookkeeping.

Two exporters:

* :meth:`Tracer.to_chrome` — the Chrome ``trace_event`` JSON object
  format (``{"traceEvents": [...]}``, ``ph="X"`` complete events with
  microsecond ``ts``/``dur``).  Load it at https://ui.perfetto.dev or
  ``chrome://tracing``.
* :meth:`Tracer.to_jsonl` — one plain JSON object per line, for ad-hoc
  ``jq``/pandas analysis without a trace viewer.

Every event carries its own ``id`` (a per-tracer sequence number) and
the ``id`` of its ``parent``: the span open on the recording thread when
it began, so a span names the span that caused it.  Work the recording
thread hands elsewhere (a copy on a side CUDA stream) is recorded after
the fact by :meth:`Tracer.complete` on a named *track*: its own ``tid``
and depth 0, out of the recording thread's nesting, its parent the span
that issued it.  On one thread's own events, at each depth the intervals
are disjoint and every child lies inside its parent.

Overhead contract (the reason this module has no dependencies and no
clever features): when tracing is disabled every ``span()`` call returns
the shared :data:`NULL_SPAN` singleton after one attribute check — no
allocation, no clock read, no lock.  The enabled-path cost is two
``perf_counter_ns`` reads plus one locked ``deque.append`` per span.

Enable with ``REPRO_TRACE=1`` (the ``REPRO_SERVE_*`` env idiom) or
programmatically via :func:`repro_torch.obs.configure`.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time


class _NullSpan:
    """Shared no-op span: the entire disabled-mode tracing surface."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


NULL_SPAN = _NullSpan()


class _Span:
    """One live span (context manager); records itself into the tracer
    ring buffer on exit.  ``set(**attrs)`` adds attributes mid-span."""

    __slots__ = ("_tracer", "name", "attrs", "_t0", "_depth", "_id",
                 "_parent")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self._depth, self._id, self._parent = self._tracer._push()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self._t0
        self._tracer._pop()
        self._tracer._record(self.name, self._t0, dur, self._depth,
                             self.attrs, span_id=self._id,
                             parent=self._parent)
        return False

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)


class Tracer:
    """Ring-buffered span recorder (thread-safe).

    ``capacity`` bounds the buffer (oldest spans drop first);
    ``enabled=None`` reads the ``REPRO_TRACE`` env knob.
    """

    def __init__(self, capacity: int = 1 << 16,
                 enabled: bool | None = None):
        if capacity < 1:
            raise ValueError(f"capacity={capacity} must be >= 1")
        if enabled is None:
            enabled = os.environ.get("REPRO_TRACE", "0") not in ("", "0")
        self.enabled = bool(enabled)
        self.capacity = capacity
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._t_origin = time.perf_counter_ns()
        self._ids = itertools.count()
        self._tracks: dict[str, int] = {}
        self._builds = 0
        self.n_dropped = 0

    # ---- recording --------------------------------------------------------

    def span(self, name: str, **attrs):
        """A context manager timing ``name``; disabled -> :data:`NULL_SPAN`."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, attrs)

    def build_span(self, name: str, **attrs):
        """A build's root span: :meth:`span` with ``build``, the number of
        build spans this tracer opened before it, among its attributes."""
        if not self.enabled:
            return NULL_SPAN
        with self._lock:
            attrs["build"] = self._builds
            self._builds += 1
        return _Span(self, name, attrs)

    def current(self) -> int | None:
        """The ``id`` of the innermost span open on the calling thread
        (None outside every span, or when disabled)."""
        stack = getattr(self._local, "stack", None)
        return stack[-1] if self.enabled and stack else None

    def instant(self, name: str, **attrs) -> None:
        """A zero-duration point event (rendered as an arrow/mark)."""
        if not self.enabled:
            return
        stack = self._stack()
        self._record(name, time.perf_counter_ns(), 0, len(stack), attrs,
                     ph="i", parent=stack[-1] if stack else None)

    def complete(self, name: str, t_start_ns: int, dur_ns: int, *,
                 track: str | None = None, parent: int | None = None,
                 **attrs) -> None:
        """Record an explicitly-timed span (e.g. a queue wait measured
        from a request's admission timestamp); ``t_start_ns`` on the
        ``time.perf_counter_ns`` clock.  Without ``track`` it sits on the
        calling thread at the current depth, its parent the open span (or
        ``parent``).  With ``track`` it goes on that named track (its own
        ``tid``, depth 0), out of the calling thread's nesting; ``parent``
        is then the id of the span that issued the work (see
        :meth:`current`)."""
        if not self.enabled:
            return
        if track is None:
            stack = self._stack()
            depth, tid = len(stack), None
            if parent is None and stack:
                parent = stack[-1]
        else:
            depth = 0
            with self._lock:
                tid = self._tracks.setdefault(track, len(self._tracks) + 1)
        self._record(name, t_start_ns, dur_ns, depth, attrs, parent=parent,
                     tid=tid, track=track)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _push(self) -> tuple[int, int, int | None]:
        """(depth, id, parent id) of a span opening on this thread."""
        stack = self._stack()
        span_id = next(self._ids)
        parent = stack[-1] if stack else None
        stack.append(span_id)
        return len(stack) - 1, span_id, parent

    def _pop(self) -> None:
        stack = self._stack()
        if stack:
            stack.pop()

    def _record(self, name, t0_ns, dur_ns, depth, attrs, ph="X", *,
                span_id=None, parent=None, tid=None, track=None) -> None:
        evt = {
            "name": name,
            "ph": ph,
            "ts_ns": t0_ns - self._t_origin,
            "dur_ns": dur_ns,
            "tid": threading.get_ident() if tid is None else tid,
            "depth": depth,
            "id": next(self._ids) if span_id is None else span_id,
            "parent": parent,
            "track": track,
            "args": attrs,
        }
        with self._lock:
            if len(self._events) >= self.capacity:
                # ring semantics without deque: drop the oldest half in one
                # slice (amortized O(1) per append, keeps events ordered)
                drop = max(1, self.capacity // 2)
                del self._events[:drop]
                self.n_dropped += drop
            self._events.append(evt)

    # ---- inspection / export ----------------------------------------------

    def events(self) -> list[dict]:
        """A snapshot copy of the buffered events (oldest first)."""
        with self._lock:
            return [dict(e) for e in self._events]

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.n_dropped = 0
            self._builds = 0

    def to_chrome(self) -> dict:
        """The Chrome ``trace_event`` object format (Perfetto-loadable).

        Spans carrying a ``shard`` attribute (the sharded index fabric
        stamps one on every per-shard dispatch) get that shard id as
        their ``pid``, so a multi-shard run renders as one process track
        per shard and traces from different shards merge side by side;
        everything else stays on the host process track.  Each event's
        ``id`` and ``parent`` go under ``args`` as ``span_id`` and
        ``parent_id``; an event on a track gets the track's row, named
        after it.
        """
        pid = os.getpid()
        out = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": "repro-era"}}]
        shard_pids: set[int] = set()
        tracks: dict[int, str] = {}
        for e in self.events():
            if e["track"] is not None:
                tracks[e["tid"]] = e["track"]
            cat = e["name"].split("/", 1)[0]
            shard = e["args"].get("shard")
            if isinstance(shard, (int, float)) and not isinstance(shard, bool):
                evt_pid = int(shard)
                shard_pids.add(evt_pid)
            else:
                evt_pid = pid
            evt = {
                "name": e["name"],
                "cat": cat,
                "ph": e["ph"],
                "ts": e["ts_ns"] / 1e3,   # trace_event ts is microseconds
                "pid": evt_pid,
                "tid": e["tid"],
                "args": {**{k: _jsonable(v) for k, v in e["args"].items()},
                         "span_id": e["id"], "parent_id": e["parent"]},
            }
            if e["ph"] == "X":
                evt["dur"] = e["dur_ns"] / 1e3
            else:
                evt["s"] = "t"            # instant scope: thread
            out.append(evt)
        for tid, track in sorted(tracks.items()):
            out.insert(1, {"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": track}})
        for k in sorted(shard_pids):
            out.insert(1, {"name": "process_name", "ph": "M", "pid": k,
                           "tid": 0, "args": {"name": f"repro-era shard {k}"}})
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def to_jsonl(self) -> str:
        """One JSON object per line: name, ph, ts_ns, dur_ns, tid, depth,
        id, parent, track, args."""
        lines = []
        for e in self.events():
            e = dict(e, args={k: _jsonable(v) for k, v in e["args"].items()})
            lines.append(json.dumps(e, sort_keys=True))
        return "\n".join(lines) + ("\n" if lines else "")

    def write_chrome(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path

    def write_jsonl(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_jsonl())
        return path


def _jsonable(v):
    """Attributes must survive json.dumps; numpy scalars and other
    oddballs degrade to their Python/str forms rather than raising."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    for cast in (int, float):
        try:
            return cast(v)
        except (TypeError, ValueError):
            continue
    return str(v)


def validate_chrome_trace(obj) -> list[str]:
    """Validate an object against the ``trace_event`` JSON schema subset
    this module emits.  Returns a list of problems (empty = valid) so a
    checker can print every violation instead of stopping at the first."""
    errors: list[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["top level must be an object with a 'traceEvents' list"]
    events = obj["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' must be a list"]
    for i, e in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(e, dict):
            errors.append(f"{where}: not an object")
            continue
        for key in ("name", "ph", "pid", "tid"):
            if key not in e:
                errors.append(f"{where}: missing {key!r}")
        if not isinstance(e.get("name"), str):
            errors.append(f"{where}: name must be a string")
        ph = e.get("ph")
        if ph not in ("X", "B", "E", "i", "I", "M", "C"):
            errors.append(f"{where}: unknown phase {ph!r}")
        if ph == "M":
            continue
        if not isinstance(e.get("ts"), (int, float)) or e.get("ts", -1) < 0:
            errors.append(f"{where}: ts must be a number >= 0")
        if ph == "X" and (not isinstance(e.get("dur"), (int, float))
                          or e.get("dur", -1) < 0):
            errors.append(f"{where}: complete event needs dur >= 0")
        if "args" in e and not isinstance(e["args"], dict):
            errors.append(f"{where}: args must be an object")
    return errors

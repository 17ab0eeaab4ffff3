"""PyTorch port vs the JAX package: the flight recorder.

``repro_torch.obs`` is the port's own copy of ``repro.obs``; the port's
construction, streaming, append, fabric and serving sites record the JAX
package's spans, instants and metric series.  On the CPU:

(a) the recorders alone, fed the same events with the clock patched to a
    counter, export the same Chrome trace, JSONL and Prometheus text but
    for the port's event ids and parents; the knobs off hand out the
    shared null span and instrument;
(b) ``build`` (``node_lcp="words"``), ``build_device``, ``build_stream``
    in several chunks, the serial engine, ``append_device``, and
    ``build_sharded`` / ``find_batch`` / ``find_fetch_batch`` /
    ``append_sharded`` on 2 shards: the port records every JAX span in
    JAX's order, with JAX's timing-free attributes and the same nesting
    among them, once its own spans (``PORT_ONLY``) are taken out; its own
    spans appear where they should, nest on the recording thread, and the
    stream's standby copy sits on its own track; the build's timers and
    byte counters add up to the copies the build makes;
(c) the serving stack, single and sharded, records the same series and
    label sets, equal counter values and histogram counts, and every
    dispatch's link joins a queue wait;
(d) the kernel-dispatch series carry JAX's (kernel, currency) labels on
    the word, byte-string and ``REPRO_WORD_COMPARE=byte`` legs, all
    ``impl="ref"`` on the CPU;
(e) ``start_metrics_server`` serves the live registry; shard spans go to
    their own process track.

Every fixture leaves both packages' recorders as it found them.  JAX's
kernel-dispatch records fire when a jitted function is traced, so the
fixtures that read them clear JAX's caches first.  Tolerance: exact.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest

from repro import obs as jobs
from repro.core.alphabet import ALPHABETS as J_ALPHABETS
from repro.core.api import EraConfig as JConfig
from repro.core.api import EraIndexer as JIndexer
from repro.launch import serving as jserving
from repro_torch import obs as tobs
from repro_torch.core import iomodel
from repro_torch.core.alphabet import ALPHABETS
from repro_torch.core.api import BuildReport, EraConfig, EraIndexer
from repro_torch.core.prepare import PrepareStats
from repro_torch.core.vertical import VerticalStats, vertical_partition
from repro_torch.data.strings import dataset
from repro_torch.launch import serving as tserving

ROOT = Path(__file__).resolve().parents[1]
PKGS = (jobs, tobs)
N = 2_000
CFG = dict(memory_bytes=2048, r_bytes=256)
# attributes that carry wall time, left out of the comparison
TIMED = {"stream/pipeline": {"copy_ms", "hidden_ms", "overlap_frac"},
         "stream/standby_copy": {"wait_ms", "hidden_frac", "copy_ms"}}
# the port's own spans, which name its host work, and the operations
# that record each (``vertical/refine`` only under position refinement)
PORT_SPANS = {
    "build": {"build/text", "vertical/upload", "vertical/count",
              "vertical/group", "prepare/init", "build/slice",
              "nodes/rows", "nodes/lcp", "nodes/cartesian", "nodes/extract"},
    "build_device": {"build/device", "build/text", "vertical/upload",
                     "vertical/count", "vertical/group", "prepare/init",
                     "build/flatten", "flatten/segments", "flatten/routes",
                     "flatten/text", "flatten/to_host"},
    "build_stream": {"build/stream", "build/text", "vertical/upload",
                     "vertical/count", "vertical/group", "stream/host_init",
                     "stream/copy", "stream/drain", "build/flatten",
                     "flatten/segments", "flatten/routes", "flatten/text",
                     "flatten/to_host"},
}
PORT_ONLY = set().union(*PORT_SPANS.values()) | {"vertical/refine"}
ROOTS = {"build": "build/total", "build_device": "build/device",
         "build_stream": "build/stream"}
SERVE_COUNTERS = ("serve_requests_total", "serve_batches_total",
                  "serve_rows_real_total", "serve_rows_padded_total",
                  "serve_cache_hits_total", "serve_cache_misses_total",
                  "serve_rejected_total")
SERVE_HISTOGRAMS = ("serve_queue_depth", "serve_batch_fill",
                    "serve_queue_wait_ms", "serve_batch_age_ms")


@dataclasses.dataclass
class Capture:
    """One package's recording of one operation."""
    events: list
    prom: str
    result: object = None


def _saved_state():
    return [(o, o.trace_enabled(), o.metrics_enabled()) for o in PKGS]


def _restore(saved) -> None:
    for o, t, m in saved:
        o.configure(trace=t, metrics_on=m, clear=True)


def _record(o, fn) -> Capture:
    """``fn()`` with ``o``'s recorder on and empty before it runs."""
    o.configure(trace=True, metrics_on=True, clear=True)
    result = fn()
    return Capture(o.tracer().events(), o.metrics().to_prometheus(), result)


def _as_jax(events: list) -> list:
    """The port's events as the JAX package records them: its own spans
    taken out and every depth recounted over the ancestors left.  JAX
    records a standby copy in the issuing thread's nesting, at its issuing
    span's depth; the port puts it on a track, its parent that span."""
    by_id = {e["id"]: e for e in events}

    def depth(e) -> int:
        d, parent = 0, e["parent"]
        while parent is not None:
            d += by_id[parent]["name"] not in PORT_ONLY
            parent = by_id[parent]["parent"]
        return d - (e["track"] is not None)

    return [dict(e, depth=depth(e)) for e in events
            if e["name"] not in PORT_ONLY]


def _spans(cap: Capture, port: bool = False) -> list:
    """(name, depth, timing-free attributes) of every span and complete
    event, in recording order; ``port``: seen as JAX records them."""
    events = _as_jax(cap.events) if port else cap.events
    return [(e["name"], e["depth"],
             {k: v for k, v in e["args"].items()
              if k not in TIMED.get(e["name"], ())})
            for e in events if e["ph"] == "X"]


def _series(prom: str) -> dict:
    """{(name, labels): value} of every sample line of Prometheus text."""
    out = {}
    for line in prom.splitlines():
        if not line or line.startswith("#"):
            continue
        m = re.fullmatch(r"([a-z_]+)(\{[^}]*\})? (\S+)", line)
        assert m, line
        out[(m.group(1), m.group(2) or "")] = float(m.group(3))
    return out


def _dispatch_labels(prom: str) -> set:
    """{(kernel, impl, currency)} of the ``kernel_dispatch_total`` series."""
    out = set()
    for (name, labels) in _series(prom):
        if name == "kernel_dispatch_total":
            kv = dict(re.findall(r'(\w+)="([^"]*)"', labels))
            out.add((kv["kernel"], kv["impl"], kv["currency"]))
    return out


def _patterns(s, base: int, rng) -> list:
    """Planted patterns of 1-12 symbols, random ones, and one carrying
    the terminal code (byte keys on a dense index)."""
    pats = []
    for m in (1, 2, 3, 5, 8, 12):
        for _ in range(3):
            i = int(rng.integers(0, len(s) - 1 - m))
            pats.append(np.asarray(s[i:i + m], np.int32))
        pats.append(rng.integers(0, base - 1, size=m, dtype=np.int32))
    pats.append(np.asarray(list(s[-4:-1]) + [base - 1], np.int32))
    return pats


# ---- (a) the recorders alone ------------------------------------------


def _drive(o) -> tuple:
    """One fixed sequence of spans, instants, complete events, counters,
    gauges and histograms on fresh recorders of package ``o``."""
    tr = o.Tracer(enabled=True)
    m = o.Metrics(enabled=True)
    with tr.span("build/total", n=100, engine="batched"):
        with tr.span("prepare/step", w=4) as sp:
            tr.instant("kernel/range_gather/dispatch", kernel="range_gather",
                       rows=np.int64(7), ratio=np.float32(0.5))
            sp.set(n_active=3, label=object.__class__)
        tr.complete("serve/queue_wait", 15_000, 1_234, rows=2, link=1)
    with tr.span("fabric/find_batch", shard=2, rows=4):
        pass
    with tr.span("serve/pad_pack", rows=8, b_pad=8, m_pad=16):
        pass
    m.counter("serve_requests_total", "requests admitted").inc(3)
    m.counter("kernel_dispatch_total", "dispatches", kernel="suffix_lcp",
              impl="ref", currency="word").inc()
    m.counter("kernel_dispatch_total", "dispatches", kernel="range_gather",
              impl="ref", currency="byte").inc(2)
    m.gauge("prepare_r_budget_symbols", "budget").set(512)
    m.gauge("serve_cache_hit_rate", fn=lambda: 0.25, help="hit rate")
    m.gauge("serve_queue_depth_now", fn=lambda: 1 / 0, help="broken")
    h = m.histogram("serve_queue_depth", buckets=o.pow2_buckets(1, 64),
                    help="depth")
    for v in (1, 3, 3, 17, 64, 100):
        h.observe(v)
    m.histogram("serve_queue_wait_ms", help="wait").observe(0.3)
    return tr, m


def _without_ids(chrome: dict) -> dict:
    """A Chrome export without the port's ``span_id`` / ``parent_id``."""
    events = [dict(e, args={k: v for k, v in e["args"].items()
                            if k not in ("span_id", "parent_id")})
              for e in chrome["traceEvents"]]
    return dict(chrome, traceEvents=events)


def test_recorders_export_alike(monkeypatch):
    outs = []
    for o in PKGS:
        clock = iter(range(10_000, 10**9, 1_000))
        monkeypatch.setattr(time, "perf_counter_ns", lambda: next(clock))
        outs.append(_drive(o))
    (jt, jm), (tt, tm) = outs
    assert _without_ids(tt.to_chrome()) == jt.to_chrome()
    lines = [json.loads(ln) for ln in tt.to_jsonl().splitlines()]
    assert [{k: v for k, v in e.items() if k not in ("id", "parent", "track")}
            for e in lines] == [json.loads(ln)
                                for ln in jt.to_jsonl().splitlines()]
    # ids in opening order; each event names the span open around it
    names = {e["id"]: e["name"] for e in lines}
    assert [(e["name"], names.get(e["parent"])) for e in lines] == [
        ("kernel/range_gather/dispatch", "prepare/step"),
        ("prepare/step", "build/total"),
        ("serve/queue_wait", "build/total"), ("build/total", None),
        ("fabric/find_batch", None), ("serve/pad_pack", None)]
    assert len(names) == len(lines) and all(e["track"] is None
                                            for e in lines)
    no_help = lambda p: [ln for ln in p.splitlines()
                         if not ln.startswith("# HELP")]
    assert no_help(tm.to_prometheus()) == no_help(jm.to_prometheus())
    assert tm.snapshot() == jm.snapshot()
    assert tobs.validate_chrome_trace(tt.to_chrome()) == []
    chrome = tt.to_chrome()["traceEvents"]
    assert {e["args"]["name"] for e in chrome if e["ph"] == "M"} == {
        "repro-era", "repro-era shard 2"}
    assert tobs.validate_chrome_trace({"traceEvents": [{"ph": "Q"}]}) \
        == jobs.validate_chrome_trace({"traceEvents": [{"ph": "Q"}]})


def test_knobs_off_and_clear(tmp_path, monkeypatch):
    saved = _saved_state()
    try:
        tobs.configure(trace=False, metrics_on=False, clear=True)
        assert tobs.tracer().span("serve/pad_pack", rows=1) is tobs.NULL_SPAN
        assert tobs.metrics().counter("x_total") is tobs.NULL_INSTRUMENT
        assert tobs.metrics().histogram("h") is tobs.NULL_INSTRUMENT
        with tobs.tracer().span("serve/pad_pack") as sp:
            sp.set(rows=1)
        tobs.tracer().instant("i")
        tobs.tracer().complete("c", 0, 1)
        assert tobs.tracer().events() == []
        monkeypatch.chdir(tmp_path)
        assert tobs.export_all() == []
        assert list(tmp_path.iterdir()) == []
        tobs.configure(trace=True, metrics_on=True)
        with tobs.tracer().span("serve/pad_pack"):
            pass
        tobs.metrics().counter("x_total").inc()
        monkeypatch.setenv("REPRO_TRACE_OUT", str(tmp_path / "t.json"))
        written = tobs.export_all(metrics_path=str(tmp_path / "m.prom"))
        assert written == [str(tmp_path / "t.json"), str(tmp_path / "m.prom")]
        assert "x_total 1.0" in (tmp_path / "m.prom").read_text()
        tobs.configure(clear=True)
        assert tobs.tracer().events() == []
        assert tobs.metrics().instruments() == []
        for knob, cls in (("REPRO_TRACE", tobs.Tracer),
                          ("REPRO_METRICS", tobs.Metrics)):
            monkeypatch.setenv(knob, "1")
            assert cls().enabled
            monkeypatch.setenv(knob, "0")
            assert not cls().enabled
    finally:
        _restore(saved)


# ---- (b) builds ---------------------------------------------------------


@pytest.fixture(scope="module")
def builds():
    """Each construction path through both packages with the recorders
    on: {operation: (JAX capture, port capture)}, plus the union of every
    operation's kernel-dispatch labels per package (JAX's caches cleared
    first, so each jitted path traces inside the window), the port's
    ``BuildReport`` of ``build``, ``build_device`` and ``build_stream``,
    and the string and indexer they ran on."""
    saved = _saved_state()
    jax.clear_caches()
    s, _ = dataset("dna", N, seed=1)
    ext = np.random.default_rng(3).integers(0, 4, size=120).astype(s.dtype)
    s2 = np.concatenate([s[:-1], ext, s[-1:]])
    pats = _patterns(s, J_ALPHABETS["dna"].base, np.random.default_rng(5))
    ix = {"jax": JIndexer(J_ALPHABETS["dna"], JConfig(**CFG)),
          "torch": EraIndexer(ALPHABETS["dna"], EraConfig(**CFG),
                              device="cpu")}
    groups = ix["torch"].partition(s)
    cap = ix["torch"]._capacity(groups)
    budget = iomodel.state_bytes_per_group(cap) * len(groups) // 2
    out, labels, reports = {}, {"jax": set(), "torch": set()}, {}

    def report(pkg, op):
        if pkg == "jax":
            return None
        reports[op] = BuildReport(VerticalStats(), PrepareStats())
        return reports[op]

    try:
        def run(op, make):
            caps = []
            for pkg, o in zip(("jax", "torch"), PKGS):
                caps.append(_record(o, lambda: make(pkg)))
                labels[pkg] |= _dispatch_labels(caps[-1].prom)
            out[op] = tuple(caps)
            return caps

        def indexer(pkg, **kw):
            if pkg == "jax":
                return JIndexer(J_ALPHABETS["dna"], JConfig(**CFG, **kw))
            return EraIndexer(ALPHABETS["dna"], EraConfig(**CFG, **kw),
                              device="cpu")

        run("build", lambda p: indexer(p, node_lcp="words").build(
            s, report(p, "build")))
        devs = run("build_device", lambda p: ix[p].build_device(
            s, report(p, "build_device"), max_pattern_len=64))
        run("build_stream", lambda p: ix[p].build_stream(
            s, report(p, "build_stream"), device_budget=budget,
            max_pattern_len=64))
        run("serial", lambda p: indexer(p, construction="serial").build(s))
        dev = {"jax": devs[0].result, "torch": devs[1].result}
        run("append_device", lambda p: ix[p].append_device(dev[p], s2))
        shs = run("build_sharded", lambda p: ix[p].build_sharded(
            s, n_shards=2, max_pattern_len=64))
        sh = {"jax": shs[0].result, "torch": shs[1].result}
        run("find_batch", lambda p: sh[p].find_batch(pats))
        run("find_fetch_batch", lambda p: sh[p].find_fetch_batch(
            pats, fetch=16))
        run("append_sharded", lambda p: ix[p].append_sharded(sh[p], s2))
    finally:
        _restore(saved)
    return out, labels, reports, (s, ix["torch"])


@pytest.mark.parametrize("op", ["build", "build_device", "build_stream",
                                "serial", "append_device", "build_sharded",
                                "find_batch", "find_fetch_batch",
                                "append_sharded"])
def test_build_spans_match_jax(builds, op):
    """Every JAX span, in JAX's order and nesting, with JAX's timing-free
    attributes, once the port's own spans are taken out."""
    jcap, tcap = builds[0][op]
    want, got = _spans(jcap), _spans(tcap, port=True)
    assert [x[:2] for x in got] == [x[:2] for x in want]
    assert got == want
    names = {x[0] for x in got}
    expect = {"build": {"build/total", "build/vertical", "prepare/batch_loop",
                        "prepare/step", "build/nodes", "build/node_bucket"},
              "build_stream": {"stream/pipeline", "stream/chunk",
                               "stream/standby_copy", "prepare/step"},
              "serial": {"build/total", "prepare/group", "prepare/step"},
              "append_device": {"append/total", "append/classify",
                                "append/prepare", "prepare/batch_loop"},
              "build_sharded": {"build/vertical", "fabric/shard_loop",
                                "fabric/step"},
              "find_batch": {"fabric/find_batch"},
              "find_fetch_batch": {"fabric/find_fetch"},
              "append_sharded": {"append/total", "fabric/find_batch"}}
    assert expect.get(op, {"build/vertical"}) <= names
    if op == "build_stream":
        chunks = [a for n, _, a in got if n == "stream/pipeline"][0]["chunks"]
        assert chunks >= 2
    if op in ("find_batch", "find_fetch_batch"):
        assert {a["shard"] for n, _, a in got} == {0, 1}
        pids = {e["pid"] for e in
                _as_tracer(tcap.events).to_chrome()["traceEvents"]}
        assert {0, 1} <= pids


def _as_tracer(events):
    tr = tobs.Tracer(enabled=True)
    tr._events = list(events)
    return tr


@pytest.mark.parametrize("op", ["build", "build_device", "build_stream"])
def test_port_spans_nest(builds, op):
    """On the recording thread, at each depth the spans are disjoint and
    every event lies inside the span it names as its parent, one depth
    below it; the build's own root holds everything."""
    events = builds[0][op][1].events
    by_id = {e["id"]: e for e in events}
    main = [e for e in events if e["track"] is None]
    assert len({e["tid"] for e in main}) == 1
    by_depth: dict = {}
    for e in main:
        if e["ph"] == "X":
            by_depth.setdefault(e["depth"], []).append(
                (e["ts_ns"], e["ts_ns"] + e["dur_ns"]))
    for rows in by_depth.values():
        rows.sort()
        assert all(a[1] <= b[0] for a, b in zip(rows, rows[1:]))
    for e in main:
        if e["parent"] is None:
            assert e["depth"] == 0 and e["ph"] == "X"
            continue
        p = by_id[e["parent"]]
        assert p["depth"] == e["depth"] - 1 and p["ph"] == "X"
        assert p["ts_ns"] <= e["ts_ns"]
        assert e["ts_ns"] + e["dur_ns"] <= p["ts_ns"] + p["dur_ns"]
    roots = [e for e in main if e["parent"] is None]
    assert [e["name"] for e in roots] == [ROOTS[op]]
    if op != "build":
        assert roots[0]["args"] == {"n": N + 1, "build": 0}  # terminal too


@pytest.mark.parametrize("op", ["build", "build_device", "build_stream",
                                "refine"])
def test_port_spans_recorded(builds, op):
    """Each of the port's own spans is recorded by the operation that
    should record it, and those that move data carry their bytes."""
    if op == "refine":
        saved = _saved_state()
        try:
            tobs.configure(trace=True, clear=True)
            s, _ = dataset("dna", 600, seed=4)
            vertical_partition(s, ALPHABETS["dna"].base, 40,
                               strategy="positions", device="cpu")
            events = tobs.tracer().events()
        finally:
            _restore(saved)
        assert {e["name"] for e in events} == {"vertical/upload",
                                               "vertical/refine"}
        return
    events = builds[0][op][1].events
    assert PORT_SPANS[op] <= {e["name"] for e in events}
    moves = ("vertical/upload", "vertical/count", "build/text", "flatten/",
             "build/slice", "nodes/rows", "nodes/extract", "stream/host",
             "stream/copy", "stream/drain")
    for e in events:
        if e["name"].startswith(moves):
            assert e["args"]["bytes"] > 0, e["name"]


def test_standby_copy_on_its_own_track(builds):
    """The stream's standby copies sit on the ``cuda/side_stream`` track,
    out of the recording thread's nesting, each the child of the
    ``stream/chunk`` that issued it; Chrome draws the track as a named
    row of its own."""
    events = builds[0]["build_stream"][1].events
    by_id = {e["id"]: e for e in events}
    main_tid = next(e["tid"] for e in events if e["parent"] is None)
    copies = [e for e in events if e["name"] == "stream/standby_copy"]
    assert copies
    for e in copies:
        assert (e["track"], e["depth"]) == ("cuda/side_stream", 0)
        assert e["tid"] != main_tid
        issuer = by_id[e["parent"]]
        assert issuer["name"] == "stream/chunk"
        assert e["args"]["chunk"] == issuer["args"]["chunk"] + 1
    chrome = _as_tracer(events).to_chrome()["traceEvents"]
    assert tobs.validate_chrome_trace({"traceEvents": chrome}) == []
    rows = {e["tid"] for e in chrome if e["name"] == "stream/standby_copy"}
    assert len(rows) == 1 and {"name": "cuda/side_stream"} in [
        e["args"] for e in chrome
        if e["ph"] == "M" and e["name"] == "thread_name"
        and e["tid"] in rows]


def _partition_copies(dev, n: int) -> tuple[int, int]:
    """(to the device, to the host) bytes of the partition's copies, from
    the index's prefix table alone: the string and its pad, per depth the
    int64 candidate codes (every symbol at depth 1, then every symbol
    after each proper prefix of a sub-tree's prefix) and their counts
    (int32 kernel bins up to 2^16 of them, else int64), and per
    sub-tree its int64 code and (lo, hi) bounds."""
    base = dev.base
    plen = dev.sub_plen.numpy()
    prefixes = [tuple(r[:k]) for r, k in zip(dev.sub_prefix.numpy(), plen)]
    inner = {p[:k] for p in prefixes for k in range(1, len(p))}
    depths = [1] + [len(q) + 1 for q in inner]  # base candidates each
    counts = sum(base * (4 if base**t <= 1 << 16 else 8) for t in depths)
    pad = max(63 // int(np.ceil(np.log2(base))), 2)
    t_subtrees = len(prefixes)
    return (n + pad + 8 * base * len(depths) + 8 * t_subtrees,
            counts + 16 * t_subtrees)


def test_build_timers_and_copies(builds):
    """``t_text``, ``t_flatten`` and ``t_slice`` time their stages;
    ``build_device`` counts exactly the copies it makes: the partition's,
    the construction text, the state's four per-segment vectors, the
    flatten's two segment vectors, the index's tables and served text,
    and ``ell_host`` back."""
    _, _, reports, (s, _) = builds
    tree, index, stream = (reports[op] for op in
                           ("build", "build_device", "build_stream"))
    assert tree.t_text > 0 and tree.t_slice > 0
    assert tree.t_slice <= tree.t_prepare and tree.t_flatten == 0
    assert index.t_text > 0 and index.t_flatten > 0 and index.t_slice == 0
    assert stream.t_text > 0 and stream.t_flatten > 0
    dev = builds[0]["build_device"][1].result
    assert index.bytes_to_host >= dev.ell_host.nbytes
    v_dev, v_host = _partition_copies(dev, len(s))
    t_subtrees = dev.n_subtrees
    tables = sum(getattr(dev, k).nbytes for k in (
        "sub_off", "sub_freq", "sub_prefix", "sub_plen", "win_lo", "win_hi",
        "pows", "spans"))
    assert index.bytes_to_host == v_host + dev.ell_host.nbytes
    # the dense texts upload their real codes; the words are made there
    assert index.bytes_to_device == (
        v_dev + (len(s) - 1) + 24 * t_subtrees
        + 16 * t_subtrees + tables + (len(s) - 1))
    # the stream: every chunk's state to the device and back, the
    # positions read for its host state, ell_host
    sdev, srep = builds[0]["build_stream"][1].result
    assert srep.bytes_copied > 0
    assert stream.bytes_to_device >= srep.bytes_copied + v_dev
    assert stream.bytes_to_host == (v_host + srep.bytes_copied
                                    + 8 * (len(s)) + sdev.ell_host.nbytes)
    # the tree: the state's four fields read for the slicing, the node
    # sets (three int32 fields of two slots a leaf) and rows sent
    assert tree.bytes_to_host > 16 * len(s) + 24 * len(s)
    assert tree.bytes_to_device > tree.bytes_to_host // 8


def test_prepare_metrics_match_jax(builds):
    """Every construction path records JAX's prepare series, with equal
    run counts and iteration histograms."""
    for op in ("build", "build_stream", "serial", "build_sharded"):
        jcap, tcap = builds[0][op]
        want = {k: v for k, v in _series(jcap.prom).items()
                if k[0].startswith(("prepare_", "build_"))
                and k[0] != "prepare_convergence_seconds_total"}
        got = {k: v for k, v in _series(tcap.prom).items()
               if k[0].startswith(("prepare_", "build_"))
               and k[0] != "prepare_convergence_seconds_total"}
        assert got == want, op
    assert ("prepare_group_iterations_count", "") in _series(
        builds[0]["build"][1].prom)


# ---- (c) serving ----------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    """``run_closed_loop`` in sync mode with the route cache on, through
    both packages, on a single index and on 2 shards: {backend: (JAX
    capture, port capture)}, each capture's result the server's stats."""
    saved = _saved_state()
    s, _ = dataset("dna", N, seed=2)
    pats = jserving.make_hot_workload(s, np.random.default_rng(4),
                                      n_requests=96, hot_pool=6,
                                      hot_frac=0.7, min_len=4, max_len=12)
    cfg = dict(pipeline=False, cache_size=512, max_batch=32)
    out = {}
    try:
        for o in PKGS:
            o.configure(trace=False, metrics_on=False, clear=True)
        jx = JIndexer(J_ALPHABETS["dna"], JConfig(**CFG, build_impl="none"))
        tx = EraIndexer(ALPHABETS["dna"],
                        EraConfig(**CFG, build_impl="none"), device="cpu")
        idx = {"single": (jx.build_device(s, max_pattern_len=64),
                          tx.build_device(s, max_pattern_len=64)),
               "sharded": (jx.build_sharded(s, n_shards=2,
                                            max_pattern_len=64),
                           tx.build_sharded(s, n_shards=2,
                                            max_pattern_len=64))}
        for backend, (jdev, tdev) in idx.items():
            out[backend] = (
                _record(jobs, lambda: jserving.run_closed_loop(
                    jdev, pats, jserving.ServeConfig(**cfg))[1]),
                _record(tobs, lambda: tserving.run_closed_loop(
                    tdev, pats, tserving.ServeConfig(**cfg))[1]))
    finally:
        _restore(saved)
    return out


@pytest.mark.parametrize("backend", ["single", "sharded"])
def test_serving_metrics_match_jax(served, backend):
    jcap, tcap = served[backend]
    # kernel_* series: JAX records them when a jitted search traces, the
    # port on every dispatch; their labels are held in (d)
    keep = lambda prom: {k: v for k, v in _series(prom).items()
                         if not k[0].startswith("kernel_")}
    want, got = keep(jcap.prom), keep(tcap.prom)
    assert set(got) == set(want)
    for name in SERVE_COUNTERS:
        assert got[(name, "")] == want[(name, "")], name
    for name in SERVE_HISTOGRAMS:
        assert got[(f"{name}_count", "")] == want[(f"{name}_count", "")]
    for key in got:  # the fill and depth buckets hold the same counts
        if key[0] in ("serve_batch_fill_bucket", "serve_queue_depth_bucket"):
            assert got[key] == want[key], key
    stats = tcap.result
    assert got[("serve_batches_total", "")] == stats["batches"]
    assert got[("serve_cache_hits_total", "")] == stats["cache"]["hits"] > 0
    assert got[("serve_cache_hit_rate", "")] == pytest.approx(
        stats["cache"]["hit_rate"])


@pytest.mark.parametrize("backend", ["single", "sharded"])
def test_serving_spans_match_jax(served, backend):
    jcap, tcap = served[backend]
    drop = {"serve/queue_wait"}  # its rows and link are compared below
    want = [x for x in _spans(jcap) if x[0] not in drop]
    got = [x for x in _spans(tcap, port=True) if x[0] not in drop]
    assert got == want
    waits = [x for x in _spans(tcap, port=True)
             if x[0] == "serve/queue_wait"]
    assert waits == [x for x in _spans(jcap) if x[0] == "serve/queue_wait"]
    links = {a["link"] for _, _, a in waits}
    dispatch = [a for n, _, a in got if n == "serve/device_dispatch"]
    assert dispatch and {a["link"] for a in dispatch} <= links
    if backend == "sharded":
        assert {a["shard"] for a in dispatch} == {0, 1}
    assert tobs.validate_chrome_trace(
        _as_tracer(tcap.events).to_chrome()) == []


def test_server_binds_null_instruments_when_off():
    saved = _saved_state()
    try:
        tobs.configure(trace=False, metrics_on=False)
        s, _ = dataset("dna", 400, seed=3)
        dev = EraIndexer(ALPHABETS["dna"], EraConfig(build_impl="none"),
                         device="cpu").build_device(s)
        server = tserving.AsyncServer(dev, tserving.ServeConfig())
        assert server._m_requests is tobs.NULL_INSTRUMENT
        assert server._h_batch_fill is tobs.NULL_INSTRUMENT
        assert server._tr.span("serve/pad_pack") is tobs.NULL_SPAN
        assert server._trace_on is False and server._metrics_on is False
        tobs.configure(trace=True, metrics_on=True, clear=True)
        on = tserving.AsyncServer(dev, tserving.ServeConfig())
        on.update_index(dataclasses.replace(dev, epoch=dev.epoch + 1))
        swap = [e for e in tobs.tracer().events()
                if e["name"] == "serve/index_swap"]
        assert swap[0]["args"] == {"epoch": dev.epoch + 1, "flushed": 1,
                                   "shards": 1}
        assert tobs.metrics().counter("serve_cache_flushes_total").value == 1
    finally:
        _restore(saved)


# ---- (d) kernel dispatch ---------------------------------------------------


def _leg_labels(name: str, compare: str | None) -> dict:
    """build_device, find_batch and find_fetch_batch of ``name`` through
    both packages (JAX under ``REPRO_KERNELS=jnp``, its caches cleared):
    {package: kernel-dispatch labels}."""
    saved = _saved_state()
    env = {"REPRO_KERNELS": "jnp", "REPRO_WORD_COMPARE": compare}
    old = {k: os.environ.get(k) for k in env}
    try:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        jax.clear_caches()
        s, _ = dataset(name, 1_500, seed=6)
        pats = _patterns(s, J_ALPHABETS[name].base, np.random.default_rng(7))
        out = {}
        for pkg, o in zip(("jax", "torch"), PKGS):
            ix = (JIndexer(J_ALPHABETS[name], JConfig(**CFG)) if pkg == "jax"
                  else EraIndexer(ALPHABETS[name], EraConfig(**CFG),
                                  device="cpu"))

            def leg():
                dev = ix.build_device(s, max_pattern_len=64)
                dev.find_batch(pats)
                dev.find_fetch_batch(pats, fetch=16)
            out[pkg] = _dispatch_labels(_record(o, leg).prom)
        return out
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        _restore(saved)


@pytest.mark.parametrize("leg", ["word", "byte_string", "byte_compare"])
def test_kernel_dispatch_labels_match_jax(builds, leg):
    if leg == "word":
        got = builds[1]
    else:
        got = _leg_labels(*{"byte_string": ("protein", None),
                            "byte_compare": ("dna", "byte")}[leg])
    strip = lambda labels: {(k, c) for k, _, c in labels}
    assert got["torch"] and strip(got["torch"]) == strip(got["jax"])
    assert {impl for _, impl, _ in got["torch"]} == {"ref"}
    want = {"word": {("range_gather", "word"), ("suffix_lcp", "word"),
                     ("pattern_probe", "word"), ("probe_gather", "word")},
            "byte_string": {("range_gather", "byte"),
                            ("pattern_probe", "byte")},
            "byte_compare": {("range_gather", "packed"),
                             ("pattern_probe", "packed"),
                             ("probe_gather", "packed")}}[leg]
    assert want <= strip(got["torch"])


# ---- (e) the endpoint and the shard tracks -------------------------------


def test_metrics_endpoint_serves_live_registry():
    saved = _saved_state()
    server = None
    try:
        tobs.configure(trace=False, metrics_on=True, clear=True)
        tobs.metrics().counter("serve_requests_total", "admitted").inc(5)
        server = tserving.start_metrics_server(0)
        port = server.server_address[1]
        for path in ("/metrics", "/"):
            body = urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=5).read().decode()
            assert body == tobs.metrics().to_prometheus()
        assert "serve_requests_total 5.0" in body
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=5)
        assert err.value.code == 404
    finally:
        if server is not None:
            server.shutdown()
        _restore(saved)


def test_shard_spans_get_shard_pid():
    tr = tobs.Tracer(enabled=True)
    with tr.span("fabric/find_batch", shard=2, rows=4):
        pass
    with tr.span("serve/pad_pack", rows=8):
        pass
    chrome = tr.to_chrome()
    assert tobs.validate_chrome_trace(chrome) == []
    events = chrome["traceEvents"]
    assert "repro-era shard 2" in {e["args"].get("name") for e in events
                                   if e["ph"] == "M"}
    assert next(e for e in events
                if e["name"] == "fabric/find_batch")["pid"] == 2
    assert next(e for e in events
                if e["name"] == "serve/pad_pack")["pid"] == os.getpid()


def test_quickstart_example_runs_on_cpu(tmp_path):
    """``examples/torch_quickstart.py`` end to end on the CPU at a small n,
    its flight-recorder section writing a valid trace."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_quickstart.py"),
         "--device", "cpu", "--n", "4000", "--out-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "flight recorder" in out.stdout
    assert "no counterpart in the port" in out.stdout
    import json
    trace = json.loads((tmp_path / "era_trace.json").read_text())
    assert tobs.validate_chrome_trace(trace) == []
    assert "serve_cache_hits_total" in (tmp_path / "era_metrics.prom"
                                        ).read_text()

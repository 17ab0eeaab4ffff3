"""PyTorch port vs the JAX package: find-and-fetch and the serving stack.

The same ``DNA.random_string(4000, seed=11)`` index is built in both
packages (the fixture of ``tests/test_serving.py``; the port on the CPU),
and ``find_fetch_batch``, ``find_batch_cached``, ``RouteCache``,
``ServeConfig``, ``AsyncServer`` and ``run_closed_loop`` are held against
the JAX package array for array: dense DNA, dense and byte PROTEIN_CLASS,
a batch carrying the terminal code, and ``REPRO_WORD_COMPARE=byte``.
``query_serve --index-path`` archives load in the other package's
``query_serve``.
Tolerance: exact.
"""

import dataclasses
import time

import numpy as np
import pytest

from repro.core.alphabet import DNA, PROTEIN_CLASS
from repro.core.api import EraConfig as JConfig
from repro.core.api import EraIndexer as JIndexer
from repro.core.query import RouteCache as JRouteCache
from repro.launch import query_serve as j_query_serve
from repro.launch import serving as jserving
from repro_torch.core.alphabet import ALPHABETS
from repro_torch.core.api import EraConfig, EraIndexer
from repro_torch.core.query import RouteCache
from repro_torch.launch import query_serve as t_query_serve
from repro_torch.launch.serving import (
    AsyncServer,
    ServeConfig,
    make_hot_workload,
    run_closed_loop,
    serve_stream,
)


def _both(alpha, s, mpl=64, **cfg):
    """The same string indexed by both packages (the port on the CPU)."""
    jdev = JIndexer(alpha, JConfig(memory_bytes=1 << 16, build_impl="none",
                                   **cfg)).build_device(s, max_pattern_len=mpl)
    tdev = EraIndexer(ALPHABETS[alpha.name], EraConfig(
        memory_bytes=1 << 16, build_impl="none", **cfg),
        device="cpu").build_device(s, max_pattern_len=mpl)
    return jdev, tdev


@pytest.fixture(scope="module")
def devs():
    s = DNA.random_string(4000, seed=11)
    jdev, tdev = _both(DNA, s, packing="dense")
    return jdev, tdev, s


@pytest.fixture(scope="module")
def workload(devs):
    s = devs[2]
    return make_hot_workload(s, np.random.default_rng(3), n_requests=300,
                             hot_pool=12, hot_frac=0.7, min_len=2,
                             max_len=18, n_symbols=4)


@pytest.fixture(scope="module")
def protein_devs():
    s = PROTEIN_CLASS.random_string(1200, seed=5)
    return {p: _both(PROTEIN_CLASS, s, packing=p) for p in ("dense", "bytes")}, s


def _assert_fetch_equal(got, want):
    (r_t, w_t), (r_j, w_j) = got, want
    assert len(r_t) == len(r_j)
    for a, b in zip(r_t, r_j):
        np.testing.assert_array_equal(a, b)
    assert w_t.dtype == np.int32
    np.testing.assert_array_equal(w_t, np.asarray(w_j))


def test_workload_equals_jax(devs, workload):
    want = jserving.make_hot_workload(devs[2], np.random.default_rng(3),
                                      n_requests=300, hot_pool=12,
                                      hot_frac=0.7, min_len=2, max_len=18,
                                      n_symbols=4)
    for a, b in zip(workload, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fetch", [4, 16, 32, 64])
def test_find_fetch_batch_dense_dna(devs, workload, fetch):
    """Fetch narrower and wider than the patterns, up to max_pattern_len."""
    jdev, tdev, _ = devs
    pats = workload[:80]
    _assert_fetch_equal(tdev.find_fetch_batch(pats, fetch=fetch),
                        jdev.find_fetch_batch(pats, fetch=fetch))


def test_find_fetch_ranges_equal(devs, workload):
    """Device results (start, count, window, verified) array for array;
    verified is 0 wherever the pattern occurs."""
    jdev, tdev, _ = devs
    padded, lengths, route = jdev.pad_batch(workload[:64])
    want = jdev.find_fetch_ranges(padded, lengths, route, fetch=16)
    got = tdev.find_fetch_ranges(padded, lengths, route, fetch=16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[3].numpy()[got[1].numpy() > 0] == 0).all()


def test_windows_match_read_symbols(devs, workload):
    _, tdev, _ = devs
    pats = workload[:40]
    start, count = (t.numpy() for t in tdev.find_batch_ranges(
        *tdev.pad_batch(pats)))
    _, wins = tdev.find_fetch_batch(pats, fetch=16)
    pos0 = tdev.ell_host[np.clip(start, 0, tdev.n_leaves - 1)]
    ref = tdev.read_symbols(pos0, 16).numpy()
    assert (wins[count == 0] == -1).all()
    np.testing.assert_array_equal(wins[count > 0], ref[count > 0])


@pytest.mark.parametrize("packing", ["dense", "bytes"])
def test_find_fetch_batch_protein_class(protein_devs, packing):
    devs_by_packing, s = protein_devs
    jdev, tdev = devs_by_packing[packing]
    assert tdev.packed == (packing == "dense")
    rng = np.random.default_rng(8)
    pats = [np.asarray(s[i : i + m]) for i, m in zip(
        rng.integers(0, 1100, 12), rng.integers(1, 14, 12))]
    pats += [rng.integers(0, len(PROTEIN_CLASS.symbols), size=5).astype(np.uint8)]
    _assert_fetch_equal(tdev.find_fetch_batch(pats, fetch=20),
                        jdev.find_fetch_batch(pats, fetch=20))


def test_dense_and_byte_windows_identical(protein_devs):
    devs_by_packing, s = protein_devs
    rng = np.random.default_rng(9)
    pats = [np.asarray(s[i : i + m]) for i, m in zip(
        rng.integers(0, 1190, 16), rng.integers(1, 14, 16))]
    pats.append(np.asarray(s[-6:]))  # ends in the terminal: window past |S|
    r_d, w_d = devs_by_packing["dense"][1].find_fetch_batch(pats, fetch=20)
    r_b, w_b = devs_by_packing["bytes"][1].find_fetch_batch(pats, fetch=20)
    for a, b in zip(r_d, r_b):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(w_d, w_b)


def test_find_fetch_terminal_bearing_batch(devs):
    """A batch carrying the terminal code takes the byte-key probe (and the
    fused packed kernel's plain version) on the dense text, as JAX."""
    jdev, tdev, s = devs
    term = DNA.terminal_code
    pats = [np.asarray(s[len(s) - k:]) for k in (1, 2, 3, 5, 9)]
    pats += [np.array([c, term], np.uint8) for c in range(term)]
    pats += [np.asarray(s[100:112])]
    _assert_fetch_equal(tdev.find_fetch_batch(pats, fetch=16),
                        jdev.find_fetch_batch(pats, fetch=16))


def test_find_fetch_byte_compare_leg(devs, workload, monkeypatch):
    monkeypatch.setenv("REPRO_WORD_COMPARE", "byte")
    jdev, tdev, _ = devs
    pats = workload[:60]
    got = tdev.find_fetch_batch(pats, fetch=32)
    _assert_fetch_equal(got, jdev.find_fetch_batch(pats, fetch=32))
    monkeypatch.delenv("REPRO_WORD_COMPARE")
    _assert_fetch_equal(got, tdev.find_fetch_batch(pats, fetch=32))


def test_fetch_validation(devs):
    _, tdev, s = devs
    for fetch in (6, 0, tdev.max_pattern_len + 4):
        with pytest.raises(ValueError, match="fetch"):
            tdev.find_fetch_batch([np.asarray(s[:4])], fetch=fetch)


def test_route_key_equal(devs, workload):
    jdev, tdev, _ = devs
    for p in workload[:50] + [np.asarray([3]), np.asarray([0, 4, 1])]:
        assert tdev.route_key(p) == jdev.route_key(p)


@pytest.mark.parametrize("capacity", [128, 3])
def test_find_batch_cached_equal(devs, workload, capacity):
    """Results, and the cache's counters, equal JAX's; capacity 3 runs
    under eviction pressure."""
    jdev, tdev, _ = devs
    pats = workload[:60]
    tc, jc = RouteCache(capacity), JRouteCache(capacity)
    want = tdev.find_batch(pats)
    for _ in range(2):
        got = tdev.find_batch_cached(pats * 2, tc)
        jgot = jdev.find_batch_cached(pats * 2, jc)
        for g, j, w in zip(got, jgot, want * 2):
            np.testing.assert_array_equal(g, j)
            np.testing.assert_array_equal(g, w)
    assert tc.stats() == jc.stats()
    assert tc.hits > 0 and tc.misses > 0


def test_route_cache_lru_and_counters():
    c = RouteCache(capacity=2)
    c.put("a", (0, 1))
    c.put("b", (1, 2))
    assert c.get("a") == (0, 1)   # refresh a
    c.put("c", (2, 3))            # evicts b (LRU)
    assert c.get("b") is None
    assert c.get("a") == (0, 1) and c.get("c") == (2, 3)
    assert c.evictions == 1 and c.hits == 3 and c.misses == 1
    assert c.hit_rate == 0.75 and c.stats()["size"] == 2
    c.clear()
    assert len(c) == 0
    zero = RouteCache(capacity=0)
    zero.put("a", (0, 1))
    assert zero.get("a") is None and len(zero) == 0
    with pytest.raises(ValueError):
        RouteCache(capacity=-1)


def test_serve_config_env_and_overrides(monkeypatch):
    env = {"REPRO_SERVE_MAX_BATCH": "64", "REPRO_SERVE_CACHE": "17",
           "REPRO_SERVE_PIPELINE": "0", "REPRO_SERVE_FETCH": "8",
           "REPRO_SERVE_QUEUE_DEPTH": "99", "REPRO_SERVE_MAX_WAIT_MS": "2.5"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = ServeConfig(), jserving.ServeConfig()
    assert vars(got) == vars(want)
    assert got.max_batch == 64 and got.cache_size == 17
    assert got.pipeline is False and got.fetch == 8
    assert got.queue_depth == 99 and got.max_wait_ms == 2.5
    assert ServeConfig(max_batch=8).max_batch == 8
    for k in env:
        monkeypatch.delenv(k)
    assert vars(ServeConfig()) == vars(jserving.ServeConfig())
    with pytest.raises(TypeError):
        ServeConfig(not_a_knob=1)
    for bad in (dict(max_batch=0), dict(queue_depth=0), dict(fetch=6)):
        with pytest.raises(ValueError):
            ServeConfig(**bad)


MODES = [
    dict(pipeline=False, cache_size=0),   # sync baseline
    dict(pipeline=True, cache_size=0),    # overlapped pipeline
    dict(pipeline=True, cache_size=256),  # pipeline + cache
    dict(pipeline=True, cache_size=256, max_batch=16, queue_depth=32),
    dict(pipeline=False, cache_size=0, fetch=16),
    dict(pipeline=True, cache_size=128, fetch=16),
]


@pytest.mark.parametrize("kw", MODES, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_run_closed_loop_equals_jax(devs, workload, kw):
    """Every mode returns what JAX's server returns, request for request,
    with the same batches, shapes and cache counters."""
    jdev, tdev, _ = devs
    pats = workload if not kw.get("fetch") else workload[:80]
    got, st = run_closed_loop(tdev, pats, ServeConfig(**kw))
    want, jst = jserving.run_closed_loop(jdev, pats,
                                         jserving.ServeConfig(**kw))
    assert len(got) == len(pats)
    for (pos, win), (jpos, jwin) in zip(got, want):
        np.testing.assert_array_equal(pos, jpos)
        assert not pos.flags.writeable  # results may be shared by requests
        if kw.get("fetch"):
            np.testing.assert_array_equal(win, jwin)
            assert not win.flags.writeable
        else:
            assert win is None and jwin is None
    for key in ("admitted", "rejected", "served", "batches", "rows_padded",
                "shapes", "cache"):
        assert st[key] == jst[key], key
    assert st["qps"] > 0 and st["lat_p99_ms"] >= st["lat_p50_ms"]


def test_cache_on_off_identical(devs, workload):
    _, tdev, _ = devs
    on, st_on = run_closed_loop(tdev, workload, ServeConfig(
        pipeline=True, cache_size=512, max_batch=32))
    off, _ = run_closed_loop(tdev, workload, ServeConfig(
        pipeline=True, cache_size=0, max_batch=32))
    for (p1, _), (p2, _) in zip(on, off):
        np.testing.assert_array_equal(p1, p2)
    assert st_on["cache"]["hits"] > 0


def test_admission_overflow_rejects_and_counts(devs):
    _, tdev, s = devs
    server = AsyncServer(tdev, ServeConfig(queue_depth=4, pipeline=False,
                                           cache_size=0))
    pat = np.asarray(s[:6])
    assert [server.submit(i, pat) for i in range(7)] == [True] * 4 + [False] * 3
    assert server.n_admitted == 4 and server.n_rejected == 3
    server.drain()
    assert len(server.results) == 4


def test_shapes_are_bucketed_pow2(devs, workload):
    _, tdev, _ = devs
    _, stats = run_closed_loop(tdev, workload[:100], ServeConfig(
        pipeline=True, cache_size=0, max_batch=32))
    assert stats["shapes"]
    for m_pad, b_pad in stats["shapes"]:
        assert m_pad & (m_pad - 1) == 0 or m_pad == tdev.max_pattern_len
        assert b_pad & (b_pad - 1) == 0


def test_batch_aging(devs, workload):
    """A young partial batch is held, an aged one dispatches; a full one
    dispatches at once; drain ends on aging."""
    _, tdev, s = devs
    server = AsyncServer(tdev, ServeConfig(
        pipeline=False, cache_size=0, max_batch=8, max_wait_ms=60.0))
    server.submit(0, np.asarray(s[:6]))
    server.submit(1, np.asarray(s[2:8]))
    assert server.pump() is False
    assert server.results == {} and len(server.queue) == 2
    time.sleep(0.08)
    assert server.pump() is True
    assert sorted(server.results) == [0, 1] and server.n_batches == 1
    full = AsyncServer(tdev, ServeConfig(
        pipeline=False, cache_size=0, max_batch=4, max_wait_ms=1e6))
    for i, p in enumerate(workload[:4]):
        full.submit(i, p)
    assert full.pump() is True and len(full.results) == 4
    trickle = AsyncServer(tdev, ServeConfig(
        pipeline=True, cache_size=0, max_batch=64, max_wait_ms=5.0))
    for i, p in enumerate(workload[:10]):
        trickle.submit(i, p)
    trickle.drain()
    assert len(trickle.results) == 10 and trickle.inflight is None
    want = tdev.find_batch(workload[:10])
    for i, w in enumerate(want):
        np.testing.assert_array_equal(trickle.results[i][0], w)


def test_update_index_flushes_on_epoch_change(devs, workload):
    _, tdev, _ = devs
    server = AsyncServer(tdev, ServeConfig(pipeline=True, cache_size=256,
                                           max_batch=32, max_wait_ms=0.0))
    want = tdev.find_batch(workload)
    res = server.serve(workload[:64])
    for i in range(3):  # queued and in flight across the swap
        server.submit(1000 + i, workload[64 + i])
    server.pump()
    assert server.inflight is not None and len(server.cache)
    size = len(server.cache)
    same = server.update_index(tdev)  # a replica: the cache stays warm
    assert same == {"epoch": 0, "flushed": False, "shards": 1}
    assert server.inflight is None and len(server.cache) >= size
    bumped = dataclasses.replace(tdev, epoch=1)
    assert server.update_index(bumped) == {"epoch": 1, "flushed": True,
                                           "shards": 1}
    assert len(server.cache) == 0 and server.n_index_swaps == 2
    server.drain()
    res += server.serve(workload[64:128])
    for (pos, _), w in zip(res, want[:128]):
        np.testing.assert_array_equal(pos, w)
    assert sorted(server.results) == [1000, 1001, 1002]


def test_sharded_backend_refused(devs):
    """The sharded backend, refused until the fabric was ported, now
    serves: an AsyncServer over a ShardedIndex keeps a route cache per
    shard and answers as the single index, and ``serve_stream(shards=2)``
    runs."""
    _, tdev, s = devs
    ix = EraIndexer(ALPHABETS["dna"], EraConfig(
        memory_bytes=1 << 12, build_impl="none", packing="dense"),
        device="cpu")
    sh = ix.build_sharded(s, n_shards=2, mesh=["cpu"] * 2,
                          max_pattern_len=64)
    server = AsyncServer(sh, ServeConfig(max_wait_ms=0.0))
    assert server.sharded and len(server.caches) == sh.n_shards == 2
    pats = [s[i:i + m] for m in (2, 6) for i in range(0, 300, 7)]
    for (a, _), b in zip(server.serve(pats), tdev.find_batch(pats)):
        np.testing.assert_array_equal(a, b)
    report = serve_stream("dna", n=500, shards=2, device="cpu",
                          mode="cached", requests=64)
    assert report["cached"]["served"] == 64
    assert len(report["cached"]["cache"]["per_shard"]) == 2


def test_serve_stream_all_modes_cpu(tmp_path):
    path = str(tmp_path / "dna_index")
    report = serve_stream("dna", n=3000, requests=1024, device="cpu",
                          index_path=path)
    assert report["device"] == "cpu" and report["requests"] == 1024
    for mode in ("sync", "async", "cached"):
        assert report[mode]["served"] == 1024
        assert report[mode]["vs_sync"] > 0
    assert report["cached"]["cache"]["hits"] > 0
    warm = serve_stream("dna", n=3000, requests=64, device="cpu",
                        index_path=path, mode="async")
    assert set(warm) >= {"async"} and "sync" not in warm


def test_query_serve_index_path_both_ways(tmp_path):
    """A port archive serves in the JAX package's ``query_serve`` and a JAX
    archive in the port's, with the same hits as a cold build."""
    kw = dict(n=2500, batch=32, iters=3, seed=4)
    port_path = str(tmp_path / "port_index")
    cold = t_query_serve.serve_queries("dna", index_path=port_path,
                                       device="cpu", **kw)
    from_port = j_query_serve.serve_queries("dna", index_path=port_path, **kw)
    jax_path = str(tmp_path / "jax_index")
    j_query_serve.serve_queries("protein", index_path=jax_path, **kw)
    from_jax = t_query_serve.serve_queries("protein", index_path=jax_path,
                                           device="cpu", **kw)
    jax_cold = j_query_serve.serve_queries("protein", **kw)
    assert cold["hits"] == from_port["hits"] > 0
    assert from_jax["hits"] == jax_cold["hits"] > 0
    assert from_jax["n_subtrees"] == jax_cold["n_subtrees"]
    with pytest.raises(ValueError, match="max_pattern_len"):
        t_query_serve.serve_queries("dna", index_path=port_path,
                                    max_len=100, device="cpu", **kw)
    with pytest.raises(ValueError, match="must be <"):
        t_query_serve.serve_queries("dna", n=20, max_len=24, device="cpu")

"""PyTorch port vs the JAX package: the sharded index fabric.

``sharded_prepare`` on port meshes of 1, 2 and 3 CPU entries (and one of
more entries than groups) must give the JAX package's
``subtree_prepare_batch`` and one-device ``sharded_prepare`` state, all
six fields, and their ``PrepareStats``; ``plan_shards`` its cuts;
``ShardedIndex`` its ``stats()``, ``flat_table()``, ``string_codes()``,
``find_batch`` and ``find_fetch_batch``, on patterns whose routes cross
shard cuts.  Per-shard archives load across the packages both ways (and
migrated), ``append_sharded``, the sharded ``AsyncServer``,
``serve_stream(shards=2)`` and ``shard_run`` are held against JAX's.  The
JAX package runs on its one CPU device (the fabric unplaced), the port on
the CPU with a repeated-device mesh.  Each dataset's indexes are built
once a module.  Tolerance: exact.
"""

import functools
import json

import numpy as np
import pytest
import torch

from repro.core import fabric as jfab
from repro.core import prepare as jprep
from repro.core.alphabet import ALPHABETS as J_ALPHABETS
from repro.core.api import EraConfig as JConfig
from repro.core.api import EraIndexer as JIndexer
from repro.core.query import DeviceIndex as JDeviceIndex
from repro.launch import serving as jserving
from repro.launch import shard_run as j_shard_run
from repro.launch import warmstart as jwarm
from repro_torch.core import fabric
from repro_torch.core import prepare as tprep
from repro_torch.core.alphabet import ALPHABETS
from repro_torch.core.api import EraConfig, EraIndexer
from repro_torch.core.query import DeviceIndex, route_depth, shard_npz_path
from repro_torch.data.strings import dataset
from repro_torch.launch import serving as tserving
from repro_torch.launch import shard_run
from repro_torch.launch import warmstart

CPU = torch.device("cpu")
STATE_FIELDS = ("L", "start", "area", "b_off", "b_c1", "b_c2")
STATS_FIELDS = ("iterations", "ranges", "active_history", "symbols_fetched")
# JAX's own sizes (tests/test_fabric.py) and shard counts
WORKLOADS = {"dna": (6_000, 4096, 4), "protein": (4_000, 8192, 3),
             "byte": (3_000, 8192, 2)}
APPEND_FIELDS = ("n_old", "n_new", "b_star", "n_prefixes", "n_affected",
                 "leaves_rebuilt", "leaves_reused", "partition_fallback")


def _pattern_mix(s, alpha, rng, k_route):
    """Planted + random patterns, including length < k_route so some
    spans cover several route cells (the shard fan-out path); ``alpha``
    None skips the random ones (the rule of tests/test_fabric.py)."""
    pats = []
    for m in (2, 3, max(1, k_route - 1), k_route, k_route + 3, 12):
        for _ in range(4):
            i = int(rng.integers(0, len(s) - 1 - m))
            pats.append(np.asarray(s[i : i + m], np.int32))
            if alpha is not None:
                pats.append(rng.integers(0, alpha.base, size=m,
                                         dtype=np.int32))
    return pats


def _indexers(name, mem, r_bytes=512):
    kw = dict(memory_bytes=mem, r_bytes=r_bytes, build_impl="none")
    return (JIndexer(J_ALPHABETS[name], JConfig(**kw)),
            EraIndexer(ALPHABETS[name], EraConfig(**kw), device="cpu"))


@functools.lru_cache(maxsize=None)
def _built(name):
    """Per dataset, once a module: both packages' partitions and texts,
    JAX's batched and one-device sharded states with their stats, and
    both packages' ``build_sharded`` at JAX's shard count (the port's
    over a 3-entry CPU mesh)."""
    n, mem, n_shards = WORKLOADS[name]
    s, _ = dataset(name, n, seed=0)
    jix, tix = _indexers(name, mem)
    jg, tg = jix.partition(s), tix.partition(s)
    cap = tix._capacity(tg)
    assert cap == jix._capacity(jg) and len(jg) == len(tg)
    jtext, ttext = jix._device_text(s), tix._device_text(s)
    ecfg = jix.config.elastic_config()
    jstats, jsh_stats = jprep.PrepareStats(), jprep.PrepareStats()
    jref = jprep.subtree_prepare_batch(jtext, jg, cap, ecfg, jstats)
    jsh = jfab.sharded_prepare(jtext, jg, cap, ecfg, stats=jsh_stats)
    jsharded = jix.build_sharded(s, n_shards=n_shards, max_pattern_len=64)
    tsharded = tix.build_sharded(s, n_shards=n_shards, mesh=[CPU] * 3,
                                 max_pattern_len=64)
    return dict(name=name, s=s, alpha=ALPHABETS[name], jix=jix, tix=tix,
                jg=jg, tg=tg, cap=cap, jtext=jtext, ttext=ttext,
                jref=jref, jstats=jstats, jsh=jsh, jsh_stats=jsh_stats,
                jsharded=jsharded, tsharded=tsharded, n_shards=n_shards)


@pytest.fixture(params=sorted(WORKLOADS))
def built(request):
    return _built(request.param)


def _assert_state(want, got):
    for field in STATE_FIELDS:
        g = getattr(got, field)
        assert g.dtype == torch.int32 and g.device == CPU, field
        np.testing.assert_array_equal(np.asarray(getattr(want, field)),
                                      g.numpy(), err_msg=field)


def _assert_stats(want, got):
    for field in STATS_FIELDS:
        assert getattr(want, field) == getattr(got, field), field


def _assert_finds(want, got):
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=f"pattern {i}")


def _assert_flat(want, got):
    (p_w, f_w, e_w), (p_g, f_g, e_g) = want, got
    assert p_w == p_g
    np.testing.assert_array_equal(np.asarray(f_w), f_g)
    np.testing.assert_array_equal(np.asarray(e_w), e_g)


# ---- sharded construction ---------------------------------------------------

@pytest.mark.parametrize("n_mesh", [1, 2, 3])
def test_sharded_prepare_equal(built, n_mesh):
    """Meshes of 1, 2 and 3 CPU entries (every dataset's G is uneven
    against 2 or 3: padding groups): the six fields and the stats of
    JAX's batched engine and of its one-device ``sharded_prepare``."""
    b = built
    stats = tprep.PrepareStats()
    got = fabric.sharded_prepare(b["ttext"], b["tg"], b["cap"],
                                 b["tix"].config.elastic_config(),
                                 mesh=[CPU] * n_mesh, stats=stats)
    _assert_state(b["jref"], got)
    _assert_state(b["jsh"], got)
    _assert_stats(b["jstats"], stats)
    _assert_stats(b["jsh_stats"], stats)
    assert any(len(b["tg"]) % m for m in (2, 3))  # an uneven split


def test_sharded_prepare_more_entries_than_groups(built):
    b = built
    g = len(b["tg"])
    stats = tprep.PrepareStats()
    got = fabric.sharded_prepare(b["ttext"], b["tg"], b["cap"],
                                 b["tix"].config.elastic_config(),
                                 mesh=[CPU] * (g + 2), stats=stats)
    assert got.L.shape[0] == g
    _assert_state(b["jref"], got)
    _assert_stats(b["jstats"], stats)


def test_sharded_prepare_compact_off(monkeypatch):
    """``REPRO_COMPACT=off`` pins the batched engine's oracle, not the
    fabric's schedule: both packages' sharded prepares still compact,
    and equal JAX's batched engine under the knob (on dna)."""
    b = _built("dna")
    monkeypatch.setenv("REPRO_COMPACT", "off")
    ecfg = b["jix"].config.elastic_config()
    jstats, jsh_stats, stats = (jprep.PrepareStats(), jprep.PrepareStats(),
                                tprep.PrepareStats())
    want = jprep.subtree_prepare_batch(b["jtext"], b["jg"], b["cap"], ecfg,
                                       jstats)
    jsh = jfab.sharded_prepare(b["jtext"], b["jg"], b["cap"], ecfg,
                               stats=jsh_stats)
    got = fabric.sharded_prepare(b["ttext"], b["tg"], b["cap"],
                                 b["tix"].config.elastic_config(),
                                 mesh=[CPU] * 2, stats=stats)
    _assert_state(want, got)
    _assert_state(jsh, got)
    _assert_stats(jsh_stats, stats)
    assert jstats.iterations == stats.iterations


def test_pad_group_axis_fill_values():
    state = tprep.PrepareState(*(torch.full((2, 3), 7, dtype=torch.int32)
                                 for _ in STATE_FIELDS))
    jstate = jprep.PrepareState(*(np.full((2, 3), 7, np.int32)
                                  for _ in STATE_FIELDS))
    got = fabric._pad_group_axis(state, 5)
    _assert_state(jfab._pad_group_axis(jstate, 5), got)
    assert fabric._pad_group_axis(state, 2) is state


def test_mesh_rules():
    assert fabric.fabric_mesh(device="cpu") == [CPU]
    assert fabric.fabric_mesh(1, device="cpu") == [CPU]
    for bad in (0, 2):
        with pytest.raises(ValueError):
            fabric.fabric_mesh(bad, device="cpu")
    assert fabric.as_mesh(["cpu", "cpu"], "cpu") == [CPU, CPU]
    assert fabric.as_mesh(None, "cpu") == [CPU]
    with pytest.raises(ValueError):
        fabric.as_mesh([], "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            fabric.fabric_mesh(device="cuda")
        with pytest.raises(RuntimeError):  # a card mesh holds cards only
            fabric.as_mesh([CPU], "cuda")
    assert shard_run.round_robin_mesh(3, "cpu") == [CPU] * 3


# ---- shard planning ---------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 5])
def test_plan_shards_equal(built, n_shards):
    b = built
    prefixes, freqs, _ = b["jsharded"].flat_table()
    base = b["alpha"].base
    k_route = route_depth(base, max(len(p) for p in prefixes), 1 << 18)
    want = jfab.plan_shards(prefixes, freqs, base, k_route, n_shards)
    assert fabric.plan_shards(prefixes, freqs, base, k_route,
                              n_shards) == want
    clo, chi = fabric._entry_code_intervals(prefixes, base, k_route)
    jlo, jhi = jfab._entry_code_intervals(prefixes, base, k_route)
    np.testing.assert_array_equal(clo, jlo)
    np.testing.assert_array_equal(chi, jhi)


def test_plan_shards_edge_cases():
    # every sub-tree below one route cell: no legal cut, one shard
    prefixes = [(0, 0, 0, 1), (0, 0, 0, 2), (0, 0, 0, 3)]
    freqs = np.array([5, 6, 7], np.int32)
    want = jfab.plan_shards(prefixes, freqs, 5, 2, 3)
    got = fabric.plan_shards(prefixes, freqs, 5, 2, 3)
    assert got == want == [slice(0, 3)]
    for mod in (fabric, jfab):
        with pytest.raises(ValueError):
            mod.plan_shards(prefixes, freqs, 5, 2, 0)


# ---- the sharded index ------------------------------------------------------

def test_sharded_index_equal(built):
    """``stats()``, ``flat_table()``, ``string_codes()``, ``find_batch``
    and ``find_fetch_batch(fetch=8)`` equal JAX's, on patterns whose
    routes fan out over shards; the flat table equals the one-shot's."""
    b = built
    jsh, tsh = b["jsharded"], b["tsharded"]
    assert tsh.stats() == jsh.stats()
    assert tsh.n_shards == b["n_shards"] and tsh.n_leaves == jsh.n_leaves
    assert tsh.devices == [CPU] * tsh.n_shards and tsh.epoch == 0
    _assert_flat(jsh.flat_table(), tsh.flat_table())
    np.testing.assert_array_equal(np.asarray(jsh.string_codes()),
                                  tsh.string_codes())
    np.testing.assert_array_equal(tsh.string_codes(), b["s"])
    np.testing.assert_array_equal(tsh.route2shard, jsh.route2shard)
    pats = _pattern_mix(b["s"], b["alpha"], np.random.default_rng(3),
                        tsh.k_route)
    assert [tsh.shard_span(p) for p in pats] == \
        [jsh.shard_span(p) for p in pats]
    assert tsh._split_batch(pats) == jsh._split_batch(pats)
    _assert_finds(jsh.find_batch(pats), tsh.find_batch(pats))
    j_pos, j_win = jsh.find_fetch_batch(pats, fetch=8)
    t_pos, t_win = tsh.find_fetch_batch(pats, fetch=8)
    _assert_finds(j_pos, t_pos)
    assert t_win.dtype == np.int32
    np.testing.assert_array_equal(np.asarray(j_win), t_win)
    # a route key is the same on every shard, and the same as JAX's
    assert [tsh.route_key(p) for p in pats] == [jsh.route_key(p)
                                                for p in pats]


def test_short_patterns_span_shards(built):
    """Some route spans must cross a shard cut, or the fan-out path went
    untested (where ``k_route`` > 1)."""
    b = built
    sh = b["tsharded"]
    assert sh.n_shards >= 2
    spans = [sh.shard_span(np.asarray([c], np.int32))
             for c in range(b["alpha"].base)]
    if sh.k_route == 1:  # a one-symbol route: every cell on one shard
        assert all(hi == lo for lo, hi in spans)
    else:
        assert any(hi > lo for lo, hi in spans)
    assert len({d.k_route for d in sh.shards}) == 1


def test_sharded_index_placement():
    """A mesh of more than one distinct device places shard k on
    ``mesh[k % len(mesh)]``; a repeated device leaves it where it was
    built.  On the CPU the only device is ``cpu``, so placement is forced
    with ``place=True`` onto a repeated mesh."""
    s, _ = dataset("dna", 3_000, seed=0)
    _, tix = _indexers("dna", 4096)
    sh = tix.build_sharded(s, n_shards=3, mesh=[CPU] * 2, place=True,
                           max_pattern_len=64)
    assert sh.devices == [CPU] * sh.n_shards and sh.mesh == [CPU, CPU]
    moved = fabric._place_index(sh.shards[0], CPU)
    assert moved.ell_host is sh.shards[0].ell_host


# ---- archives ---------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_archives_both_ways(tmp_path, writer):
    b = _built("dna")
    base = str(tmp_path / "fab")
    (b["tsharded"] if writer == "port" else b["jsharded"]).save(base)
    files = fabric.ShardedIndex.shard_files(base)
    assert files == jfab.ShardedIndex.shard_files(base)
    assert len(files) == b["n_shards"] and files[0] == shard_npz_path(base, 0)
    t_back = fabric.ShardedIndex.load(base, device="cpu")
    j_back = jfab.ShardedIndex.load(base)
    np.testing.assert_array_equal(t_back.cell_lo, j_back.cell_lo)
    assert t_back.stats() == j_back.stats()
    pats = _pattern_mix(b["s"], b["alpha"], np.random.default_rng(9),
                        t_back.k_route)
    want = j_back.find_batch(pats)
    _assert_finds(want, t_back.find_batch(pats))
    _assert_finds(want, b["tsharded"].find_batch(pats))


def test_migrated_shard_archives_load_in_jax(tmp_path):
    s, alpha = dataset("dna", 8_000, seed=0)
    jix, tix = _indexers("dna", 64 << 10, r_bytes=1 << 20)
    sh = tix.build_sharded(s, n_shards=2, mesh=[CPU] * 2,
                           max_pattern_len=64, packing="bytes")
    assert not any(d.packed for d in sh.shards)
    base = str(tmp_path / "shidx")
    sh.save(base)
    done = warmstart.migrate_archives(base)
    assert done == fabric.ShardedIndex.shard_files(base)
    assert warmstart.migrate_archives(base) == []
    jmig = jfab.ShardedIndex.load(base)
    tmig = fabric.ShardedIndex.load(base, device="cpu")
    assert all(d.packed for d in jmig.shards)
    assert all(d.packed for d in tmig.shards)
    pats = [s[i:i + 7] for i in range(0, 64, 2)]
    want = sh.find_batch(pats)
    _assert_finds(want, tmig.find_batch(pats))
    _assert_finds(jmig.find_batch(pats), tmig.find_batch(pats))


def test_will_load_and_load_or_build_sharded(tmp_path):
    b = _built("dna")
    base = str(tmp_path / "warm_idx")
    for mod in (warmstart, jwarm):
        assert not mod.will_load(base, sharded=True)
        assert not mod.will_load(base)
        assert mod.shard_archives(None) == []
    first, s, _, _ = warmstart.load_or_build(
        base, "dna", 6_000, 0,
        load=lambda p: fabric.ShardedIndex.load(p, device="cpu"),
        build=lambda s_, a_: b["tsharded"], sharded=True)
    for mod in (warmstart, jwarm):
        assert mod.will_load(base, sharded=True)
        # the per-shard archives do not satisfy the unsharded check
        assert not mod.will_load(base)
        assert mod.shard_archives(base) == \
            fabric.ShardedIndex.shard_files(base)
    builds = []
    second, s2, alpha, _ = warmstart.load_or_build(
        base, "dna", 6_000, 0,
        load=lambda p: fabric.ShardedIndex.load(p, device="cpu"),
        build=lambda *a: builds.append(1), sharded=True)
    assert not builds  # a cache hit: build never called
    assert len(s2) == 6_000 + 1  # the FULL string, not shard 0's slice
    np.testing.assert_array_equal(s2, s)
    j_obj, j_s, _, _ = jwarm.load_or_build(
        base, "dna", 6_000, 0, load=jfab.ShardedIndex.load,
        build=lambda *a: builds.append(1), sharded=True)
    assert not builds
    np.testing.assert_array_equal(np.asarray(j_s), s2)
    assert second.stats() == j_obj.stats() == first.stats()


# ---- append -----------------------------------------------------------------

@pytest.fixture(scope="module")
def appended():
    """A 2-shard dna index at 16,000 (the size of tests/test_stream.py)
    appended by both packages, into 2 shards and into 3."""
    s, alpha = dataset("dna", 16_000, seed=0)
    kw = dict(memory_bytes=64 << 10, build_impl="none")
    jix = JIndexer(J_ALPHABETS["dna"], JConfig(**kw))
    tix = EraIndexer(alpha, EraConfig(**kw), device="cpu")
    rng = np.random.default_rng(3)  # the JAX tests' ``_appended`` rule
    s_new = np.concatenate([s[:-1], rng.integers(0, alpha.base - 1, size=900,
                                                 dtype=np.uint8), s[-1:]])
    jsh = jix.build_sharded(s, n_shards=2, max_pattern_len=64)
    tsh = tix.build_sharded(s, n_shards=2, mesh=[CPU] * 2,
                            max_pattern_len=64)
    out = {}
    for n_shards in (None, 3):
        out[n_shards] = (jix.append_sharded(jsh, s_new, n_shards=n_shards),
                         tix.append_sharded(tsh, s_new, n_shards=n_shards))
    return tix, tsh, s_new, out


@pytest.mark.parametrize("n_shards", [None, 3])
def test_append_sharded_equal(appended, n_shards):
    tix, tsh, s_new, out = appended
    (jsh2, jrep), (tsh2, trep) = out[n_shards]
    for key in APPEND_FIELDS:
        assert getattr(jrep, key) == getattr(trep, key), key
    assert trep.leaves_rebuilt + trep.leaves_reused == tsh2.n_leaves
    assert tsh2.epoch == jsh2.epoch == tsh.epoch + 1
    assert tsh2.n_shards == jsh2.n_shards == (n_shards or tsh.n_shards)
    assert tsh2.stats() == jsh2.stats()
    assert tsh2.mesh == tsh.mesh
    _assert_flat(jsh2.flat_table(), tsh2.flat_table())
    np.testing.assert_array_equal(tsh2.string_codes(), s_new)
    full = tix.build_sharded(s_new, n_shards=tsh2.n_shards, mesh=tsh.mesh,
                             max_pattern_len=64)
    _assert_flat(full.flat_table(), tsh2.flat_table())
    pats = [s_new[i:i + 7] for i in range(0, 128, 2)]
    pats += [s_new[len(s_new) - 1 - k:len(s_new) - 1] for k in (3, 8)]
    _assert_finds(full.find_batch(pats), tsh2.find_batch(pats))


# ---- the sharded serving backend --------------------------------------------

@pytest.mark.parametrize("fetch,cache", [(0, 0), (0, 256), (8, 256)])
def test_sharded_server_equal(fetch, cache):
    """On the 4-shard dna index, two passes (the second hits the caches
    across batches): every request's positions and window, and
    ``stats()["cache"]`` with ``per_shard``, equal JAX's sharded
    server."""
    b = _built("dna")
    pats = _pattern_mix(b["s"], b["alpha"], np.random.default_rng(11),
                        b["tsharded"].k_route)
    kw = dict(pipeline=True, cache_size=cache, fetch=fetch, max_wait_ms=0.0)
    jsrv = jserving.AsyncServer(b["jsharded"], jserving.ServeConfig(**kw))
    tsrv = tserving.AsyncServer(b["tsharded"], tserving.ServeConfig(**kw))
    assert tsrv.sharded and len(tsrv.caches) == b["n_shards"]
    for _ in range(2):
        want, got = jsrv.serve(pats), tsrv.serve(pats)
        for i, ((wp, ww), (gp, gw)) in enumerate(zip(want, got)):
            np.testing.assert_array_equal(np.asarray(wp), gp,
                                          err_msg=f"request {i}")
            if fetch:
                np.testing.assert_array_equal(np.asarray(ww), gw,
                                              err_msg=f"request {i}")
            else:
                assert gw is None
    j_st, t_st = jsrv.stats(), tsrv.stats()
    assert t_st["cache"] == j_st["cache"]
    assert len(t_st["cache"]["per_shard"]) == b["n_shards"]
    for key in ("admitted", "served", "batches", "rows_padded", "shapes"):
        assert t_st[key] == j_st[key], key
    if cache:
        assert t_st["cache"]["hits"] > 0


def test_update_index_sharded_and_back():
    """DeviceIndex → the 2-shard byte index → DeviceIndex: JAX's
    ``update_index`` dicts and cache counts, and answers equal after each
    swap."""
    b = _built("byte")
    prefixes, freqs, ell = b["tsharded"].flat_table()
    kw = dict(prefixes=prefixes, freqs=freqs, max_pattern_len=64)
    tdev = DeviceIndex.from_prepare(alphabet=b["alpha"], s=b["s"],
                                    ell=torch.from_numpy(ell), device="cpu",
                                    **kw)
    jdev = JDeviceIndex.from_prepare(alphabet=J_ALPHABETS["byte"], s=b["s"],
                                     ell=ell, **kw)
    pats = [np.asarray(b["s"][i:i + m], np.int32)
            for m in (1, 2, 5) for i in range(0, 600, 40)]
    cfg = dict(pipeline=True, cache_size=64, max_wait_ms=0.0)
    jsrv = jserving.AsyncServer(jdev, jserving.ServeConfig(**cfg))
    tsrv = tserving.AsyncServer(tdev, tserving.ServeConfig(**cfg))
    for jx, tx in ((b["jsharded"], b["tsharded"]), (jdev, tdev)):
        jsrv.serve(pats), tsrv.serve(pats)
        assert tsrv.update_index(tx) == jsrv.update_index(jx)
        assert len(tsrv.caches) == len(jsrv.caches)
        assert tsrv.sharded == jsrv.sharded
        assert [len(c) for c in tsrv.caches] == [len(c) for c in jsrv.caches]
        for (a, _), (c, _) in zip(jsrv.serve(pats), tsrv.serve(pats)):
            np.testing.assert_array_equal(np.asarray(a), c)
    # a same-epoch swap to a replica keeps the caches warm
    assert tsrv.update_index(tdev) == jsrv.update_index(jdev)
    assert [len(c) for c in tsrv.caches] == [len(c) for c in jsrv.caches]


# the timing fields of JAX's serve_stream report, rounded as it rounds them
TIMING = {"t_build_s": 3, "lat_p50_ms": 3, "lat_p99_ms": 3, "wall_s": 4,
          "qps": 1, "vs_sync": 2}


def _assert_report(got, want, where):
    assert set(got) - {"device"} == set(want), where
    for key, w in want.items():
        g = got[key]
        if key in TIMING:
            assert g == round(g, TIMING[key]), f"{where}.{key}"
        elif isinstance(w, dict):
            _assert_report(g, w, f"{where}.{key}")
        else:
            assert g == w, f"{where}.{key}: {g!r} != {w!r}"


def test_serve_stream_sharded_equal():
    kw = dict(n=2000, requests=192, seed=4, shards=2)
    want = jserving.serve_stream("dna", **kw)
    got = tserving.serve_stream("dna", device="cpu", **kw)
    _assert_report(got, want, "serve_stream")
    assert got["device"] == "cpu"
    assert len(got["cached"]["cache"]["per_shard"]) == 2


# ---- the driver -------------------------------------------------------------

def test_shard_run_equal(capsys):
    argv = ["--devices", "3", "--shards", "3", "--n", "6000",
            "--memory-bytes", "4096"]
    want = j_shard_run.run(j_shard_run._parse_args(argv))
    shard_run.main(argv + ["--device", "cpu", "--json"])
    got = json.loads(capsys.readouterr().out)
    assert got["shards"] == want["shards"]
    assert got["probe_hits"] == want["probe_hits"]
    assert (got["mesh"], got["devices"], got["backend"]) == (3, 1, "cpu")
    assert set(want) - {"devices", "backend"} <= set(got)


@pytest.mark.parametrize("argv", [
    [],
    ["--devices", "3", "--shards", "2", "--dataset", "protein", "--n", "9000",
     "--seed", "4", "--memory-bytes", "4096", "--mode", "bench",
     "--repeats", "2", "--sort", "lexsort", "--no-compact", "--json",
     "--autotune", "model", "--autotune-table", "build/tiles.json"],
    ["--mode", "save", "--index-path", "build/idx", "--autotune", "off"],
])
def test_shard_run_accepts_jax_command_lines(argv):
    """Every command line of JAX's ``shard_run``, its ``--autotune`` and
    ``--autotune-table`` included, parses in the port's, to the same value
    on every key the two share (the autotune flags have no effect)."""
    want = vars(j_shard_run._parse_args(argv))
    got = vars(shard_run._parse_args(argv))
    assert set(want) <= set(got)
    for key in want:
        assert got[key] == want[key], key

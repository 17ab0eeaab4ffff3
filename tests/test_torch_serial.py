"""PyTorch port vs the JAX package: the paper's serial engine.

``subtree_prepare`` (one group's elastic loop) must give the JAX
package's six ``PrepareState`` fields and ``PrepareStats`` (iterations,
ranges, active history, symbols fetched, offsets history) on dense DNA,
byte-per-symbol protein and under ``REPRO_WORD_COMPARE=byte``; its
``max_iters`` error must read the same; ``build_scan`` must give JAX's
``SubTreeNodes``; and ``EraConfig(construction="serial")`` builds under
each ``build_impl`` must give JAX's sub-tree keys, arrays and nodes.  The
port runs on the CPU.  Tolerance: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build as jbuild
from repro.core import prepare as jprep
from repro.core.alphabet import ALPHABETS as J_ALPHABETS
from repro.core.api import BuildReport as JReport
from repro.core.api import EraConfig as JConfig
from repro.core.api import EraIndexer as JIndexer
from repro.core.vertical import VerticalStats as JVStats
from repro_torch.core import build as tbuild
from repro_torch.core import prepare as tprep
from repro_torch.core.alphabet import ALPHABETS
from repro_torch.core.api import BuildReport, EraConfig, EraIndexer
from repro_torch.core.vertical import VerticalStats
from repro_torch.data.strings import dataset

FIELDS = ("L", "start", "area", "b_off", "b_c1", "b_c2")
STATS = ("iterations", "ranges", "active_history", "symbols_fetched")
# (alphabet, REPRO_WORD_COMPARE): dense word keys, the byte-key oracle on
# dense text, and the byte string
LEGS = [("dna", "word"), ("dna", "byte"), ("protein", "word")]


def _indexers(name, **kw):
    kw = dict(dict(memory_bytes=2048, r_bytes=64, build_impl="none"), **kw)
    return (JIndexer(J_ALPHABETS[name], JConfig(**kw)),
            EraIndexer(ALPHABETS[name], EraConfig(**kw), device="cpu"))


def _assert_stats(jst, tst):
    for k in STATS:
        assert getattr(tst, k) == getattr(jst, k), k
    assert len(tst.offsets_history) == len(jst.offsets_history)
    for x, y in zip(jst.offsets_history, tst.offsets_history):
        assert y.dtype == np.int64
        np.testing.assert_array_equal(y, x)


@pytest.mark.parametrize("name,compare", LEGS)
def test_subtree_prepare_matches_jax(monkeypatch, name, compare):
    """Every field and every stat of three groups' loops, the largest
    group first (the most iterations)."""
    monkeypatch.setenv("REPRO_WORD_COMPARE", compare)
    s, _ = dataset(name, 1500, seed=7)  # planted repeats: many iterations
    jix, tix = _indexers(name)
    jg, tg = jix.partition(s), tix.partition(s)
    cap = jix._capacity(jg)
    assert cap == tix._capacity(tg) and len(jg) == len(tg)
    jtext, ttext = jix._device_text(s), tix._device_text(s)
    order = sorted(range(len(jg)), key=lambda g: -jg[g].total_freq)
    for g in order[:3]:
        jstats = jprep.PrepareStats(record_offsets=True)
        tstats = tprep.PrepareStats(record_offsets=True)
        jst = jprep.subtree_prepare(jtext, jg[g], cap,
                                    jix.config.elastic_config(), jstats,
                                    group_index=g)
        tst = tprep.subtree_prepare(ttext, tg[g], cap,
                                    tix.config.elastic_config(), tstats,
                                    group_index=g)
        for f in FIELDS:
            got = getattr(tst, f)
            assert got.dtype == torch.int32 and got.shape == (cap,), f
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(getattr(jst, f)),
                                          err_msg=f"group {g} {f}")
        assert tstats.iterations > 1
        _assert_stats(jstats, tstats)


def test_subtree_prepare_is_one_group_of_the_batch():
    """The serial loop's arrays equal the batched engine's row of the
    same group (range choice never changes results)."""
    s = ALPHABETS["dna"].random_string(1500, seed=7)
    _, tix = _indexers("dna")
    groups = tix.partition(s)
    cap = tix._capacity(groups)
    text = tix._device_text(s)
    ecfg = tix.config.elastic_config()
    batch = tprep.subtree_prepare_batch(text, groups, cap, ecfg)
    for g in range(2):
        one = tprep.subtree_prepare(text, groups[g], cap, ecfg)
        for f in ("L", "b_off", "b_c1", "b_c2"):
            assert torch.equal(getattr(one, f), getattr(batch, f)[g]), f


def test_max_iters_error_matches_jax():
    s = ALPHABETS["dna"].random_string(1500, seed=7)
    jix, tix = _indexers("dna")
    jg, tg = jix.partition(s), tix.partition(s)
    cap = jix._capacity(jg)
    with pytest.raises(RuntimeError) as jerr:
        jprep.subtree_prepare(jix._device_text(s), jg[0], cap,
                              jix.config.elastic_config(), max_iters=1,
                              group_index=0)
    with pytest.raises(RuntimeError) as terr:
        tprep.subtree_prepare(tix._device_text(s), tg[0], cap,
                              tix.config.elastic_config(), max_iters=1,
                              group_index=0)
    assert str(terr.value) == str(jerr.value)
    assert "failed to converge after 1 iterations: group=0" in str(terr.value)


def _subtree_inputs():
    """(ell, b_off, n_total) of the largest real sub-tree of a build and
    of random rows of f = 1, 2 and 9."""
    s = ALPHABETS["dna"].random_string(600, seed=3)
    _, tix = _indexers("dna", memory_bytes=4096)
    big = max(tix.build(s).subtrees.values(), key=lambda st: len(st.ell))
    out = [(big.ell, big.b_off, len(s))]
    rng = np.random.default_rng(5)
    for f in (1, 2, 9):
        ell = rng.permutation(50)[:f].astype(np.int32)
        b = rng.integers(1, 12, size=f).astype(np.int32)
        b[0] = 0
        out.append((ell, b, 51))
    return out


def test_build_scan_matches_jax():
    for ell, b_off, n_total in _subtree_inputs():
        j = jbuild.build_scan(jnp.asarray(ell), jnp.asarray(b_off), n_total)
        t = tbuild.build_scan(ell, b_off, n_total)
        for k, name in enumerate(("parent", "depth", "witness")):
            assert t[k].dtype == torch.int32 and t[k].shape == (2 * len(ell),)
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]),
                                          err_msg=name)
        assert (t.n_nodes, t.n_leaves) == (int(j.n_nodes), int(j.n_leaves))
        # the scan's walk is the paper's stack builder
        want = tbuild.build_numpy(ell, b_off, n_total)
        assert tbuild.nodes_to_intervals(t) == tbuild.nodes_to_intervals(want)


def test_build_scan_returns_on_the_callers_device():
    ell = torch.tensor([5, 2, 7], dtype=torch.int32)
    b = torch.tensor([0, 1, 2], dtype=torch.int32)
    nodes = tbuild.build_scan(ell, b, 9)
    assert all(x.device.type == "cpu" for x in nodes[:3])
    assert nodes.n_nodes == tbuild.build_numpy(ell.numpy(), b.numpy(),
                                               9).n_nodes


def _assert_same_subtrees(jidx, tidx, nodes: bool):
    assert list(tidx.subtrees) == list(jidx.subtrees)
    for p, jst in jidx.subtrees.items():
        tst = tidx.subtrees[p]
        for f in ("ell", "b_off", "b_c1", "b_c2"):
            np.testing.assert_array_equal(getattr(tst, f), getattr(jst, f),
                                          err_msg=f"{p} {f}")
        if not nodes:
            assert tst.nodes is None and jst.nodes is None
            continue
        tn = tbuild.nodes_to_host(tst.nodes)
        jn = jbuild.nodes_to_host(jst.nodes)
        for k in range(3):
            np.testing.assert_array_equal(tn[k], jn[k], err_msg=str(p))
        assert (tn.n_nodes, tn.n_leaves) == (jn.n_nodes, jn.n_leaves)


@pytest.mark.parametrize("name,compare,impl", [
    *[(n, c, i) for n, c in LEGS for i in ("numpy", "none")],
    *[("dna", c, i) for c in ("word", "byte") for i in ("scan", "parallel")]])
def test_serial_build_matches_jax(monkeypatch, name, compare, impl):
    """``construction="serial"`` under each ``build_impl`` and each
    ``REPRO_WORD_COMPARE`` leg of dense text: the sub-tree keys, arrays
    and node sets of JAX's serial build, and its ``PrepareStats``.  The
    scan and parallel legs (JAX compiles one program per sub-tree size)
    run on a short DNA string of few sub-trees."""
    monkeypatch.setenv("REPRO_WORD_COMPARE", compare)
    fast = impl in ("numpy", "none")
    s = ALPHABETS[name].random_string(1500 if fast else 300, seed=11)
    mem = 2048 if fast else 16384
    jix, tix = _indexers(name, memory_bytes=mem, build_impl=impl,
                         construction="serial")
    jrep = JReport(JVStats(), jprep.PrepareStats(record_offsets=True))
    trep = BuildReport(VerticalStats(), tprep.PrepareStats(record_offsets=True))
    jidx = jix.build(s, jrep)
    tidx = tix.build(s, trep)
    assert len(tidx.subtrees) > 1
    _assert_same_subtrees(jidx, tidx, nodes=impl != "none")
    _assert_stats(jrep.prepare, trep.prepare)
    assert (trep.n_groups, trep.n_prefixes) == (jrep.n_groups,
                                                jrep.n_prefixes)


def test_serial_equals_batched_build():
    """The two engines give the same sub-trees and nodes, and
    ``build_device`` of the serial engine (build, then flatten) equals the
    batched one's."""
    s = ALPHABETS["protein"].random_string(1500, seed=2)
    kw = dict(memory_bytes=2048, r_bytes=64)
    batched = EraIndexer(ALPHABETS["protein"], EraConfig(**kw), device="cpu")
    serial = EraIndexer(ALPHABETS["protein"],
                        EraConfig(construction="serial", **kw), device="cpu")
    a, b = batched.build(s), serial.build(s)
    assert set(a.subtrees) == set(b.subtrees)
    for p, st in a.subtrees.items():  # node ids differ by builder
        np.testing.assert_array_equal(b.subtrees[p].ell, st.ell)
        assert (tbuild.nodes_to_intervals(b.subtrees[p].nodes)
                == tbuild.nodes_to_intervals(st.nodes))
    da, db = batched.build_device(s), serial.build_device(s)
    for f in ("ell", "sub_off", "sub_freq", "sub_prefix", "sub_plen"):
        assert torch.equal(getattr(da, f), getattr(db, f)), f

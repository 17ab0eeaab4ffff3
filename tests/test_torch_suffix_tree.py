"""PyTorch port vs the JAX package: ``EraIndexer.build`` → ``SuffixTreeIndex``.

On DNA, protein and byte strings the port's sub-trees (``ell``, ``b_off``,
``b_c1``, ``b_c2``) and node sets (``parent``, ``depth``, ``witness``
and their ``nodes_to_intervals`` canonical form) must equal the JAX
package's, with the divergence rows from the prepare state
(``node_lcp="state"``) and recomputed from the text (``"words"``), under
the default, ``REPRO_SORT=lexsort``, ``REPRO_COMPACT=off`` and
``REPRO_WORD_COMPARE=byte`` legs.  The JAX index is built once per string
(its arrays are leg-invariant, which the JAX package's own tests pin);
the port is built under every leg.  Then ``find``, ``find_walk`` and
``find_batch``, and archives in both directions.  The port runs on the
CPU.  Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from repro.core import build as jb
from repro.core.alphabet import ALPHABETS as J_ALPHABETS
from repro.core.api import EraConfig as JConfig
from repro.core.api import EraIndexer as JIndexer
from repro.core.suffix_tree import SuffixTreeIndex as JIndex
from repro_torch.core import build as tb
from repro_torch.core.alphabet import ALPHABETS
from repro_torch.core.api import EraConfig, EraIndexer
from repro_torch.core.suffix_tree import SuffixTreeIndex

CASES = {"dna": (1500, 2048), "protein": (1200, 4096), "byte": (900, 4096)}
LEGS = {"default": {}, "lexsort": {"REPRO_SORT": "lexsort"},
        "compact_off": {"REPRO_COMPACT": "off"},
        "byte": {"REPRO_WORD_COMPARE": "byte"}}
_JAX = {}


def _string(alpha):
    n, _ = CASES[alpha]
    s = J_ALPHABETS[alpha].random_string(n, seed=n)
    s[n // 2:n // 2 + 70] = s[30:100]  # a planted repeat: deep sub-trees
    return s


def _jax_index(alpha):
    if alpha not in _JAX:
        _, mem = CASES[alpha]
        _JAX[alpha] = JIndexer(J_ALPHABETS[alpha],
                               JConfig(memory_bytes=mem)).build(_string(alpha))
    return _JAX[alpha]


def _port_index(alpha, **kw):
    _, mem = CASES[alpha]
    return EraIndexer(ALPHABETS[alpha], EraConfig(memory_bytes=mem, **kw),
                      device="cpu").build(_string(alpha))


def _assert_same(tix, jix):
    assert sorted(tix.subtrees) == sorted(jix.subtrees)
    for p, jst in jix.subtrees.items():
        tst = tix.subtrees[p]
        for f in ("ell", "b_off", "b_c1", "b_c2"):
            np.testing.assert_array_equal(getattr(tst, f),
                                          np.asarray(getattr(jst, f)),
                                          err_msg=f"{p} {f}")
        tn, jn = tb.nodes_to_host(tst.nodes), jb.nodes_to_host(jst.nodes)
        for f in ("parent", "depth", "witness", "n_nodes", "n_leaves"):
            np.testing.assert_array_equal(np.asarray(getattr(tn, f)),
                                          np.asarray(getattr(jn, f)),
                                          err_msg=f"{p} nodes.{f}")
        assert tb.nodes_to_intervals(tn) == jb.nodes_to_intervals(jn)
    assert (tix.n_leaves, tix.n_internal) == (jix.n_leaves, jix.n_internal)


@pytest.mark.parametrize("leg", sorted(LEGS))
@pytest.mark.parametrize("node_lcp", ["state", "words"])
@pytest.mark.parametrize("alpha", sorted(CASES))
def test_node_sets_equal(monkeypatch, leg, node_lcp, alpha):
    jix = _jax_index(alpha)
    for var, val in LEGS[leg].items():
        monkeypatch.setenv(var, val)
    tix = _port_index(alpha, node_lcp=node_lcp)
    _assert_same(tix, jix)
    assert tix.device == torch.device("cpu")


def test_dense_text_byte_leg_matches_jax_byte_leg(monkeypatch):
    """The new leg on both sides: ``REPRO_WORD_COMPARE=byte`` on the dense
    DNA text (prepare through ``range_gather_packed``, node rows through
    the byte-key LCP) in the JAX package and in the port."""
    monkeypatch.setenv("REPRO_WORD_COMPARE", "byte")
    s = J_ALPHABETS["dna"].random_string(700, seed=5)
    kw = dict(memory_bytes=1024, node_lcp="words")
    jix = JIndexer(J_ALPHABETS["dna"], JConfig(**kw)).build(s)
    tix = EraIndexer(ALPHABETS["dna"], EraConfig(**kw), device="cpu").build(s)
    _assert_same(tix, jix)


def test_build_impl_none_skips_nodes():
    tix = _port_index("dna", build_impl="none")
    assert all(st.nodes is None for st in tix.subtrees.values())
    assert tix.n_internal == 0
    with pytest.raises(ValueError, match="not built"):
        tix.find_walk(np.asarray(_string("dna")[:40]))


def _patterns(s, rng, k=24):
    pats = [np.asarray(s[i:i + m]) for i, m in
            zip(rng.integers(0, len(s) - 40, k), rng.integers(1, 30, k))]
    pats += [rng.integers(0, 4, size=6).astype(np.uint8),
             np.asarray(s[len(s) - 5:])]  # one ending in the terminal
    return pats


@pytest.mark.parametrize("alpha", ["dna", "protein"])
def test_find_paths_equal(alpha):
    """find (host binary search), find_walk (tree walk) and find_batch
    (the flattened device engine) equal JAX's find and each other."""
    jix = _jax_index(alpha)
    tix = _port_index(alpha, node_lcp="words")
    s = _string(alpha)
    for p in _patterns(s, np.random.default_rng(2)):
        want = jix.find(p)
        np.testing.assert_array_equal(tix.find(p), want)
        np.testing.assert_array_equal(tix.find_walk(p), want)
        assert tix.route(p) == jix.route(p)
    pats = _patterns(s, np.random.default_rng(3))
    for got, p in zip(tix.find_batch(pats), pats):
        np.testing.assert_array_equal(got, jix.find(p))
    assert tix.to_device().device == torch.device("cpu")


def test_archives_load_both_ways(tmp_path):
    """Port → JAX and JAX → port archives hold the same sub-trees and
    nodes, and a loaded index walks its trees."""
    jix = _jax_index("protein")
    tix = _port_index("protein")
    tix.save(str(tmp_path / "port.npz"))
    jix.save(str(tmp_path / "jax.npz"))
    j_from_t = JIndex.load(str(tmp_path / "port.npz"), J_ALPHABETS["protein"])
    t_from_j = SuffixTreeIndex.load(str(tmp_path / "jax.npz"),
                                    ALPHABETS["protein"], device="cpu")
    _assert_same(t_from_j, jix)
    _assert_same(tix, j_from_t)
    np.testing.assert_array_equal(t_from_j.s, np.asarray(jix.s))
    p = np.asarray(_string("protein")[40:47])
    np.testing.assert_array_equal(t_from_j.find_walk(p), jix.find(p))
    assert t_from_j.device == "cpu"


def test_process_groups_equal():
    """The worker unit: SubTreePrepare + slicing for a list of groups,
    one sub-tree list per group, equal to the JAX package's."""
    s = _string("dna")
    _, mem = CASES["dna"]
    jix = JIndexer(J_ALPHABETS["dna"], JConfig(memory_bytes=mem))
    tix = EraIndexer(ALPHABETS["dna"], EraConfig(memory_bytes=mem),
                     device="cpu")
    jg, tg = jix.partition(s), tix.partition(s)
    cap = jix._capacity(jg)
    want = jix.process_groups(jix._device_text(s), jg, cap)
    got = tix.process_groups(tix._device_text(s), tg, cap)
    assert len(got) == len(want) > 1
    for gl, wl in zip(got, want):
        assert [st.prefix for st in gl] == [st.prefix for st in wl]
        for a, b in zip(gl, wl):
            for f in ("ell", "b_off", "b_c1", "b_c2"):
                np.testing.assert_array_equal(getattr(a, f),
                                              np.asarray(getattr(b, f)))

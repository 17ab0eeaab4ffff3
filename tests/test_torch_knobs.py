"""PyTorch port vs the JAX package: whole builds under the construction knobs.

For each knob of ``EraConfig`` that changes how an index is built
(``elastic=False`` at two static widths, ``group=False``,
``vertical_strategy="positions"``, narrow and wide elastic ranges,
``packing`` dense and bytes, ``node_lcp="words"`` and a small read
buffer), a string of about a thousand symbols goes through
``build`` → ``analytics()`` and ``build_device`` → ``find_batch`` in both
packages: every sub-tree array and node set, every analytics answer,
every index array and every lookup must be equal.  The port runs on the
CPU.  Tolerance: exact.
"""

import numpy as np
import pytest

from repro.core import build as jb
from repro.core.alphabet import ALPHABETS as J_ALPHABETS
from repro.core.api import EraConfig as JConfig
from repro.core.api import EraIndexer as JIndexer
from repro_torch.core import build as tb
from repro_torch.core.alphabet import ALPHABETS
from repro_torch.core.api import EraConfig, EraIndexer

KNOBS = {
    "static_w10": dict(elastic=False, static_w=10),
    "static_w4": dict(elastic=False, static_w=4),
    "no_group": dict(group=False),
    "positions": dict(vertical_strategy="positions"),
    "w8_64": dict(w_min=8, w_max=64),
    "w_max16": dict(w_max=16),
    "dense": dict(packing="dense"),
    "bytes": dict(packing="bytes"),
    "node_lcp_words": dict(node_lcp="words"),
    "r_bytes64": dict(r_bytes=64),
}
INDEX_FIELDS = ("ell", "sub_off", "sub_freq", "sub_prefix", "sub_plen",
                "win_lo", "win_hi", "pows", "spans")
N, MEM = 1000, 1 << 11


def _string():
    s = J_ALPHABETS["dna"].random_string(N, seed=N)
    s[N // 2:N // 2 + 60] = s[40:100]  # a planted repeat: deep sub-trees
    return s


def _patterns(s, rng):
    pats = [np.asarray(s[i:i + m]) for i, m in zip(
        rng.integers(0, N - 40, 30), rng.integers(1, 30, 30))]
    pats += [rng.integers(0, 4, int(m)).astype(np.uint8)
             for m in rng.integers(1, 9, 6)]
    return pats + [np.asarray(s[N - 12:N])]


def _analytics(eng, s):
    """Every answer of the engine, as host values."""
    q = np.concatenate([s[100:160], s[N // 2:N // 2 + 40],
                        s[:30][::-1]]).astype(np.uint8)
    ms, wit = eng.matching_stats(q, window=24)
    return {"lcp": np.asarray(eng.lcp_host), "ms": np.asarray(ms),
            "witness": np.asarray(wit), "top": eng.top_repeats(5),
            "longest": eng.longest_repeat(),
            "distinct": eng.distinct_substrings(),
            "top_kmers": [(d["kmer"].tolist(), d["count"], d["witness"])
                          for d in eng.top_kmers(3, 5)]}


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_whole_build_equal(knob):
    kw = dict(memory_bytes=MEM, **KNOBS[knob])
    s = _string()
    jix = JIndexer(J_ALPHABETS["dna"], JConfig(**kw)).build(s)
    tix = EraIndexer(ALPHABETS["dna"], EraConfig(**kw), device="cpu").build(s)
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
    got, want = _analytics(tix.analytics(), s), _analytics(jix.analytics(), s)
    for key, w in want.items():
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(got[key], w, err_msg=key)
        else:
            assert got[key] == w, key

    dkw = dict(kw, build_impl="none")
    tdev = EraIndexer(ALPHABETS["dna"], EraConfig(**dkw),
                      device="cpu").build_device(s)
    jdev = JIndexer(J_ALPHABETS["dna"], JConfig(**dkw)).build_device(s)
    for field in INDEX_FIELDS:
        np.testing.assert_array_equal(getattr(tdev, field).numpy(),
                                      np.asarray(getattr(jdev, field)),
                                      err_msg=field)
    assert tdev.packed == jdev.packed
    pats = _patterns(s, np.random.default_rng(len(knob)))
    for p, g, w in zip(pats, tdev.find_batch(pats), jdev.find_batch(pats)):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(p))

"""PyTorch port vs the JAX package: the LCP + analytics engine.

``SuffixTreeIndex.analytics()`` on DNA, protein and byte strings: the
global LCP array (boundary entries through ``ops.suffix_lcp_pairs``), the
stacked sparse tables, ``lcp_rows``, ``matching_stats``, ``top_repeats``
(also on a tie-heavy periodic string, where ``jax.lax.top_k``'s
lowest-index-first order decides the witnesses), ``distinct_substrings``,
``kmer_spectrum`` and ``top_kmers`` must equal the JAX package's under the
default, ``REPRO_SORT=lexsort``, ``REPRO_COMPACT=off`` and
``REPRO_WORD_COMPARE=byte`` legs (the JAX results are computed once per
string: they are leg-invariant, as the JAX package's own tests pin).
Then engine archives in both directions and ``analytics_serve --device
cpu``.  The port runs on the CPU.  Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from repro.core.alphabet import ALPHABETS as J_ALPHABETS
from repro.core.analytics import AnalyticsEngine as JEngine
from repro.core.api import EraConfig as JConfig
from repro.core.api import EraIndexer as JIndexer
from repro.launch import analytics_serve as j_serve
from repro_torch.core.alphabet import ALPHABETS
from repro_torch.core.analytics import AnalyticsEngine
from repro_torch.core.api import EraConfig, EraIndexer
from repro_torch.launch import analytics_serve as t_serve

CASES = {"dna": (1500, 2048), "protein": (1200, 4096), "byte": (900, 4096)}
LEGS = {"default": {}, "lexsort": {"REPRO_SORT": "lexsort"},
        "compact_off": {"REPRO_COMPACT": "off"},
        "byte": {"REPRO_WORD_COMPARE": "byte"}}
_JAX = {}


def _string(alpha):
    n, _ = CASES[alpha]
    s = J_ALPHABETS[alpha].random_string(n, seed=n + 1)
    s[n // 3:n // 3 + 90] = s[50:140]  # a planted repeat
    return s


def _query(alpha, s):
    rng = np.random.default_rng(len(s))
    q = np.concatenate([s[60:130], rng.integers(
        0, len(J_ALPHABETS[alpha].symbols), 70).astype(np.uint8),
        s[len(s) - 20:len(s) - 1]])
    return q


def _results(eng, s, alpha):
    """Everything the engine answers, as host values."""
    rng = np.random.default_rng(7)
    i = rng.integers(0, eng.total, 64)
    j = np.concatenate([rng.integers(0, eng.total, 60), i[:4]])
    q = _query(alpha, s)
    out = {"lcp": np.asarray(eng.lcp_host),
           "lcp_rows": np.asarray(eng.lcp_rows(i, j)),
           "top": eng.top_repeats(6), "longest": eng.longest_repeat(),
           "distinct": (eng.distinct_substrings(),
                        eng.distinct_substrings(include_terminal=True))}
    for window in (13, None):
        ms, wit = eng.matching_stats(q, window=window)
        out[f"ms{window}"] = (np.asarray(ms), np.asarray(wit))
    for k in (1, 3):
        out[f"spectrum{k}"] = tuple(np.asarray(x)
                                    for x in eng.kmer_spectrum(k))
        out[f"top{k}"] = [(d["kmer"].tolist(), d["count"], d["witness"])
                          for d in eng.top_kmers(k, 5)]
    return out


def _assert_results(got, want):
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        if isinstance(w, tuple) and isinstance(w[0], np.ndarray):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b, err_msg=key)
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert g == w, key


def _jax_results(alpha):
    if alpha not in _JAX:
        _, mem = CASES[alpha]
        s = _string(alpha)
        _, eng = JIndexer(J_ALPHABETS[alpha], JConfig(
            memory_bytes=mem, build_impl="none")).build_analytics(s)
        _JAX[alpha] = (eng, _results(eng, s, alpha))
    return _JAX[alpha]


def _port_engine(alpha, **kw):
    _, mem = CASES[alpha]
    cfg = EraConfig(memory_bytes=mem, build_impl="none", **kw)
    return EraIndexer(ALPHABETS[alpha], cfg,
                      device="cpu").build_analytics(_string(alpha))[1]


@pytest.mark.parametrize("leg", sorted(LEGS))
@pytest.mark.parametrize("alpha", sorted(CASES))
def test_engine_equal(monkeypatch, leg, alpha):
    jeng, want = _jax_results(alpha)
    for var, val in LEGS[leg].items():
        monkeypatch.setenv(var, val)
    eng = _port_engine(alpha)
    _assert_results(_results(eng, _string(alpha), alpha), want)
    np.testing.assert_array_equal(eng.vals.numpy(), np.stack(jeng.vals))
    np.testing.assert_array_equal(eng.vals_rev.numpy(),
                                  np.stack(jeng.vals_rev))
    assert eng.lcp.dtype == torch.int32 and eng.lcp.device.type == "cpu"


def test_engine_from_built_nodes_equal():
    """The engine of an index built with nodes (``node_lcp="words"``) is
    the same engine, shared with ``find_batch``."""
    _, want = _jax_results("dna")
    _, mem = CASES["dna"]
    index = EraIndexer(ALPHABETS["dna"], EraConfig(
        memory_bytes=mem, node_lcp="words"), device="cpu").build(_string("dna"))
    eng = index.analytics()
    assert index.analytics() is eng and eng.dev is index._device
    _assert_results(_results(eng, _string("dna"), "dna"), want)


def test_top_repeats_tie_heavy():
    """Copies of one motif planted in random text: many equal LCP rows and
    equal k-mer counts, so the top-k tie order decides the answers and
    witnesses."""
    rng = np.random.default_rng(1)
    s = J_ALPHABETS["dna"].random_string(1200, seed=1)
    motif = rng.integers(0, 4, 30).astype(np.uint8)
    for start in range(0, 750, 50):
        s[start:start + 30] = motif
    kw = dict(memory_bytes=4096, build_impl="none")
    _, jeng = JIndexer(J_ALPHABETS["dna"], JConfig(**kw)).build_analytics(s)
    _, teng = EraIndexer(ALPHABETS["dna"], EraConfig(**kw),
                         device="cpu").build_analytics(s)
    assert teng.top_repeats(12) == jeng.top_repeats(12)
    for k in (2, 4, 6):
        assert ([(d["kmer"].tolist(), d["count"], d["witness"])
                 for d in teng.top_kmers(k, 8)]
                == [(d["kmer"].tolist(), d["count"], d["witness"])
                    for d in jeng.top_kmers(k, 8)])
    top = np.sort(teng.lcp_host)[-40:]
    assert np.unique(top).size < top.size  # ties among the top entries


def test_terminal_query_and_short_served_padding():
    """A query carrying the terminal code takes the byte-key path on the
    dense text (``range_gather_packed`` + ``lcp_pairs``), and boundary
    LCPs wider than the served padding use a byte string padded for them,
    as in the JAX package."""
    s = J_ALPHABETS["dna"].random_string(900, seed=3)
    kw = dict(memory_bytes=512, build_impl="none")
    jix = JIndexer(J_ALPHABETS["dna"], JConfig(**kw)).build(s)
    tix = EraIndexer(ALPHABETS["dna"], EraConfig(**kw), device="cpu").build(s)
    max_plen = max(len(p) for p in jix.subtrees)
    assert -(-(max_plen + 1) // 4) * 4 > 4
    jeng, teng = (ix.analytics(max_pattern_len=4) for ix in (jix, tix))
    np.testing.assert_array_equal(teng.lcp_host, jeng.lcp_host)
    jeng, teng = jix.analytics(), tix.analytics()
    q = np.concatenate([s[100:140], [4], s[10:30]]).astype(np.uint8)
    for a, b in zip(teng.matching_stats(q, window=24),
                    jeng.matching_stats(q, window=24)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_engine_archives_load_both_ways(tmp_path):
    jeng, want = _jax_results("protein")
    teng = _port_engine("protein")
    teng.save(str(tmp_path / "port"))
    jeng.save(str(tmp_path / "jax"))
    j_from_t = JEngine.load(str(tmp_path / "port"))
    t_from_j = AnalyticsEngine.load(str(tmp_path / "jax"), device="cpu")
    s = _string("protein")
    _assert_results(_results(t_from_j, s, "protein"), want)
    _assert_results(_results(j_from_t, s, "protein"), want)
    jeng.dev.save(str(tmp_path / "plain"))
    with pytest.raises(ValueError, match="no 'lcp'"):
        AnalyticsEngine.load(str(tmp_path / "plain"), device="cpu")
    with pytest.raises(ValueError, match="n_leaves"):
        AnalyticsEngine.from_device(teng.dev, teng.lcp_host[:-1])


def test_analytics_serve_on_cpu_matches_jax(tmp_path):
    """``analytics_serve --device cpu`` reports what the JAX driver
    reports, cold and from its npz warm start."""
    kw = dict(n=3000, batch=128, iters=2, window=32, seed=2)
    want = j_serve.serve_analytics("dna", **kw)
    path = str(tmp_path / "eng")
    for _ in range(2):  # build + save, then load
        got = t_serve.serve_analytics("dna", index_path=path, device="cpu",
                                      **kw)
        for key in ("n_symbols", "n_subtrees", "longest_repeat",
                    "distinct_substrings", "positions", "mean_match_len"):
            assert got[key] == want[key], key
        assert got["device"] == "cpu" and got["batch_p99_ms"] > 0
    with pytest.raises(ValueError, match="base"):
        t_serve.serve_analytics("protein", index_path=path, device="cpu",
                                **kw)

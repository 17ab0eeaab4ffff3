"""PyTorch port vs the JAX package: one launch per byte-key search on dense text.

``search.search_bounds_packed`` and ``search.search_fetch_packed`` on CPU
tensors run their plain versions: ``search_loop`` with
``ref.pattern_probe_packed_ref``, and ``search.fetch_composition`` on a
``PackedText`` under byte keys (that loop, then
``ref.probe_gather_packed_ref`` at the lower bounds and the decode).  They
must equal the JAX package on the same dense index and rows, with jnp and
Pallas (interpret mode): ``repro.core.query._search_bounds(word=False)``
for the search (routed, unrouted, empty and mixed windows, both bounds
and the lower bound alone), and ``_find_fetch_batch(word=False)`` or its
search, epilogue and decode on given windows for find-and-fetch (all four
outputs; fetch 4 to 64; B = 0, 1 and 33; windows past ``n_real``;
patterns of more than 16 key words).  The texts are dense DNA (2-bit),
protein-class (4-bit) and protein packed dense (8-bit) words, the
patterns planted, random, at the text's end and running into the
terminal.  Through ``DeviceIndex``, a terminal-bearing batch and every
batch under ``REPRO_WORD_COMPARE=byte`` make one wrapper call a batch and
call neither single-step kernel (``pattern_probe_packed``,
``probe_gather_packed``); matching statistics under the byte leg equal
JAX's with one search call a batch.  The card-input checks raise before
any build.  Tolerance: exact — every quantity is an integer.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import query as jq
from repro.core.alphabet import ALPHABETS as J_ALPHABETS
from repro.core.api import EraConfig as JConfig
from repro.core.api import EraIndexer as JIndexer
from repro.kernels import ops as jops
from repro_torch.core import query as tq
from repro_torch.core.analytics import AnalyticsEngine
from repro_torch.core.query import DeviceIndex
from repro_torch.kernels import ops
from repro_torch.kernels import search as tsearch

# (alphabet, n, memory_bytes, packing) of the three dense word widths
CASES = [("dna", 1500, 2048, "auto"), ("protein_class", 900, 4096, "auto"),
         ("protein", 800, 4096, "dense")]
BITS = {"dna": 2, "protein_class": 4, "protein": 8}
IDS = [c[0] for c in CASES]
WINDOWS = ["routed", "unrouted", "empty", "mixed"]
_INDEXES = {}


def _index(alpha, n, mem, packing):
    """(s, JAX DeviceIndex, port DeviceIndex from its blobs), built once;
    a planted 300-symbol repeat gives long patterns two occurrences."""
    key = (alpha, n, mem, packing)
    if key not in _INDEXES:
        a = J_ALPHABETS[alpha]
        s = a.random_string(n, seed=n + mem + 2)
        s[n - 320:n - 20] = s[40:340]
        cfg = JConfig(memory_bytes=mem, r_bytes=128, build_impl="none")
        jdev = JIndexer(a, cfg).build_device(s, packing=packing)
        tdev = DeviceIndex.from_blobs(jdev.to_blobs(), device="cpu")
        assert tdev.packed and tdev.s_text.bits == BITS[alpha]
        _INDEXES[key] = (s, jdev, tdev)
    return _INDEXES[key]


def _patterns(s, a, rng, *, m_max=40):
    """Planted substrings, random codes (mostly absent), patterns that end
    at the text's last symbols (their windows run past n_real), patterns
    that run into the terminal, and ``[c, terminal]`` pairs."""
    n = len(s) - 1
    n_sym, term = len(a.symbols), a.terminal_code
    pats = [np.asarray(s[i:i + m]) for m in (1, 3, 8, 17, m_max)
            for i in rng.integers(0, n - m, 3)]
    pats += [rng.integers(0, n_sym, int(rng.integers(6, 14))).astype(np.uint8)
             for _ in range(8)]
    pats += [np.asarray(s[n - k:n]) for k in (1, 2, 5, 16)]
    pats += [np.append(s[n - k:n], term).astype(np.uint8)
             for k in (0, 1, 3, 9)]
    pats += [np.array([c, term], np.uint8) for c in range(min(n_sym, 5))]
    return pats


def _windows(kind, lo0, hi0, total, rng):
    """Search windows of the kind asked for, from the routed ones."""
    b = lo0.shape[0]
    zero, full = np.zeros(b, np.int32), np.full(b, total, np.int32)
    empty = rng.integers(0, total + 1, size=b).astype(np.int32)
    if kind == "routed":
        return lo0, hi0
    if kind == "unrouted":
        return zero, full
    if kind == "empty":
        return empty, empty
    pick = rng.integers(0, 3, size=b)
    return (np.choose(pick, [lo0, zero, empty]).astype(np.int32),
            np.choose(pick, [hi0, full, empty]).astype(np.int32))


def _batch(case, kind, seed, m_pad=None):
    """(s, jdev, tdev, padded, lengths, route, lo0, hi0) of one batch."""
    s, jdev, tdev = _index(*case)
    rng = np.random.default_rng(seed)
    padded, lengths, route = jdev.pad_batch(
        _patterns(s, J_ALPHABETS[case[0]], rng), m_pad=m_pad)
    lo0, hi0 = jq._route_window(jdev.win_lo, jdev.win_hi, jdev.pows,
                                jdev.spans, jnp.asarray(lengths),
                                jnp.asarray(route), jdev.k_route)
    lo0, hi0 = _windows(kind, np.asarray(lo0), np.asarray(hi0),
                        jdev.n_leaves, rng)
    return s, jdev, tdev, padded, lengths, route, lo0, hi0


def _t(x):
    return torch.from_numpy(np.array(x))


def _rows(jdev, tdev, padded, lengths):
    """The byte-key rows of both packages, held equal."""
    pat_j, mask_j = jq._pack_query_batch(jdev.s_text, jnp.asarray(padded),
                                         jnp.asarray(lengths), False)
    pat, mask = tq._pack_query_batch(tdev.s_text, _t(padded), _t(lengths),
                                     False)
    np.testing.assert_array_equal(pat.numpy().view(np.uint32),
                                  np.asarray(pat_j).view(np.uint32))
    np.testing.assert_array_equal(mask.numpy().view(np.uint32),
                                  np.asarray(mask_j).view(np.uint32))
    return pat_j, mask_j, pat, mask


@functools.lru_cache(maxsize=None)
def _jax_search(n_iter, use_pallas):
    return jax.jit(functools.partial(jq._search_bounds, n_iter=n_iter,
                                     use_pallas=use_pallas, word=False))


@functools.lru_cache(maxsize=None)
def _jax_fetch_windows(n_iter, use_pallas, fetch):
    """The body of JAX ``_find_fetch_batch`` after routing, on windows the
    caller gives: its byte-key search, its fused epilogue and its decode."""

    def run(s_text, ell, pat, mask, lengths, lo0, hi0):
        llo, ulo = jq._search_bounds(s_text, ell, pat, mask, lengths, lo0,
                                     hi0, n_iter=n_iter,
                                     use_pallas=use_pallas, word=False)
        count = jnp.maximum(ulo - llo, 0)
        pos0 = ell[jnp.clip(llo, 0, ell.shape[0] - 1)]
        cmp, win = jops.probe_gather_impl(use_pallas)(s_text, pos0, pat, mask,
                                                      fetch)
        sym = jq._window_symbols(s_text, win, pos0, fetch, False)
        return llo, count, jnp.where((count > 0)[:, None], sym, -1), cmp

    return jax.jit(run)


def _assert_fetch_equal(got, want):
    assert len(got) == len(want) == 4
    for g, w, part in zip(got, want, ("start", "count", "window",
                                      "verified")):
        assert g.dtype == torch.int32, part
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=part)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "pallas"])
@pytest.mark.parametrize("kind", WINDOWS)
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_search_bounds_packed_equal_jax(case, kind, use_pallas):
    """Both bounds, and the lower bound alone, equal JAX's search."""
    s, jdev, tdev, padded, lengths, _, lo0, hi0 = _batch(case, kind, 3)
    pat_j, mask_j, pat, mask = _rows(jdev, tdev, padded, lengths)
    llo, ulo = _jax_search(jdev.n_iter, use_pallas)(
        jdev.s_text, jdev.ell, pat_j, mask_j, jnp.asarray(lengths),
        jnp.asarray(lo0), jnp.asarray(hi0))
    got = tsearch.search_bounds_packed(tdev.s_text, tdev.ell, pat, mask,
                                       _t(lo0), _t(hi0), n_iter=tdev.n_iter,
                                       bounds=2)
    assert got.dtype == torch.int32 and got.shape == (2, len(lengths))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(llo))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ulo))
    if kind == "empty":
        np.testing.assert_array_equal(got[0].numpy(), lo0)
    low = tsearch.search_bounds_packed(tdev.s_text, tdev.ell, pat, mask,
                                       _t(lo0), _t(hi0), n_iter=tdev.n_iter,
                                       bounds=1)
    assert low.shape == (1, len(lengths))
    np.testing.assert_array_equal(low[0].numpy(), np.asarray(llo))


@pytest.mark.parametrize("kind,fetch,use_pallas", [
    ("routed", 32, False), ("routed", 32, True), ("empty", 4, False),
    ("mixed", 64, False), ("unrouted", 8, True)])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_search_fetch_packed_equal_jax(case, kind, fetch, use_pallas):
    """All four outputs equal JAX's search, epilogue and decode on the
    same windows; in routed windows some matched rows read past n_real,
    where the window holds the terminal."""
    s, jdev, tdev, padded, lengths, _, lo0, hi0 = _batch(case, kind, fetch)
    pat_j, mask_j, pat, mask = _rows(jdev, tdev, padded, lengths)
    want = _jax_fetch_windows(jdev.n_iter, use_pallas, fetch)(
        jdev.s_text, jdev.ell, pat_j, mask_j, jnp.asarray(lengths),
        jnp.asarray(lo0), jnp.asarray(hi0))
    got = tsearch.search_fetch_packed(tdev.s_text, tdev.ell, pat, mask,
                                      _t(lo0), _t(hi0), n_iter=tdev.n_iter,
                                      fetch=fetch)
    _assert_fetch_equal(got, want)
    start, count, win = (g.numpy() for g in got[:3])
    assert win.shape == (len(lengths), fetch)
    assert (win[count == 0] == -1).all()
    if kind == "empty":
        assert (count == 0).all()
        np.testing.assert_array_equal(start, lo0)
    if kind == "routed":
        pos0 = tdev.ell_host[np.clip(start, 0, tdev.n_leaves - 1)]
        past = (pos0 + fetch > len(s) - 1) & (count > 0)
        term = J_ALPHABETS[case[0]].terminal_code
        assert past.any() and (win[past, -1] == term).all()


def _jax_ranges(jdev, padded, lengths, route, fetch, use_pallas=False):
    return jq._find_fetch_batch(
        jdev.s_text, jdev.ell, jdev.win_lo, jdev.win_hi, jdev.pows,
        jdev.spans, jnp.asarray(padded), jnp.asarray(lengths),
        jnp.asarray(route), k_route=jdev.k_route, n_iter=jdev.n_iter,
        use_pallas=use_pallas, word=False, fetch=fetch)


@pytest.mark.parametrize("b", [1, 33])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_find_fetch_ranges_packed_batch_sizes(case, b):
    """A terminal-bearing batch of one pattern, and of 33 (the kernel's
    last warp half filled with lane pairs), through ``find_fetch_ranges``
    against JAX's ``_find_fetch_batch``."""
    s, jdev, tdev = _index(*case)
    a = J_ALPHABETS[case[0]]
    rng = np.random.default_rng(b)
    pats = _patterns(s, a, rng)
    pats = [pats[int(i)] for i in rng.integers(0, len(pats), b - 1)]
    pats.append(np.append(s[len(s) - 4:len(s) - 1], a.terminal_code)
                .astype(np.uint8))
    padded, lengths, route = tdev.pad_batch(pats)
    got = tdev.find_fetch_ranges(padded, lengths, route, fetch=16)
    assert got[2].shape == (b, 16)
    _assert_fetch_equal(got, _jax_ranges(jdev, padded, lengths, route, 16))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_search_packed_empty_batch(case):
    """A batch of no patterns gives empty outputs of the right shapes."""
    _, _, tdev = _index(*case)
    pat = torch.zeros((0, 3), dtype=torch.int32)
    none = torch.zeros(0, dtype=torch.int32)
    got = tsearch.search_fetch_packed(tdev.s_text, tdev.ell, pat, pat, none,
                                      none, n_iter=tdev.n_iter, fetch=12)
    assert [tuple(g.shape) for g in got] == [(0,), (0,), (0, 12), (0,)]
    assert all(g.dtype == torch.int32 for g in got)
    bnd = tsearch.search_bounds_packed(tdev.s_text, tdev.ell, pat, pat, none,
                                       none, n_iter=tdev.n_iter, bounds=2)
    assert bnd.shape == (2, 0) and bnd.dtype == torch.int32


@pytest.mark.parametrize("m,use_pallas", [(72, False), (72, True),
                                          (512, False)])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_find_fetch_wide_packed_equal_jax(monkeypatch, case, m, use_pallas):
    """Patterns of more than 16 key words (18, and 128 at max_pattern_len
    512: the kernels stage such rows in shared memory) under
    ``REPRO_WORD_COMPARE=byte``, the planted repeat found twice."""
    monkeypatch.setenv("REPRO_WORD_COMPARE", "byte")
    s, jdev, tdev = _index(*case)
    rng = np.random.default_rng(m)
    n = len(s) - 1
    mm = min(m, 300)
    pats = [np.asarray(s[i:i + mm - int(d)]) for i, d in zip(
        [40, 41, 500, n - mm], rng.integers(0, 8, 4))]
    pats.append(rng.integers(0, len(J_ALPHABETS[case[0]].symbols), m)
                .astype(np.uint8))
    padded, lengths, route = tdev.pad_batch(pats, m_pad=m)
    assert padded.shape[1] == m
    got = tdev.find_fetch_ranges(padded, lengths, route, fetch=32)
    _assert_fetch_equal(got, _jax_ranges(jdev, padded, lengths, route, 32,
                                         use_pallas))
    assert got[1].numpy()[0] == 2  # the planted repeat


def _spy(monkeypatch, calls):
    for name in ("search_bounds_packed", "search_fetch_packed",
                 "pattern_probe_packed", "probe_gather_packed",
                 "search_bounds_words", "search_fetch_words",
                 "search_loop"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *x, _r=real, _n=name, **k: (
            calls.append(_n), _r(*x, **k))[1])


@pytest.mark.parametrize("leg", ["terminal", "byte"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_index_calls_one_packed_wrapper_per_batch(monkeypatch, case, leg):
    """``find_batch_ranges`` and ``find_fetch_ranges`` on a batch that
    carries the terminal code, and on a plain batch under
    ``REPRO_WORD_COMPARE=byte``: one ``search_bounds_packed`` /
    ``search_fetch_packed`` call a batch, no single-step kernel and no
    word kernel, results equal to JAX's."""
    s, jdev, tdev = _index(*case)
    a = J_ALPHABETS[case[0]]
    rng = np.random.default_rng(8)
    pats = _patterns(s, a, rng)
    if leg == "byte":
        monkeypatch.setenv("REPRO_WORD_COMPARE", "byte")
        pats = [p for p in pats if not (p == a.terminal_code).any()]
    padded, lengths, route = tdev.pad_batch(pats)
    assert not tdev._word_gate(padded, None)
    calls = []
    _spy(monkeypatch, calls)
    start, count = tdev.find_batch_ranges(padded, lengths, route)
    assert calls == ["search_bounds_packed"]
    js, jc = jdev.find_batch_ranges(padded, lengths, route)
    np.testing.assert_array_equal(start.numpy(), np.asarray(js))
    np.testing.assert_array_equal(count.numpy(), np.asarray(jc))
    got = tdev.find_fetch_ranges(padded, lengths, route, fetch=24)
    assert calls == ["search_bounds_packed", "search_fetch_packed"]
    _assert_fetch_equal(got, _jax_ranges(jdev, padded, lengths, route, 24))
    found = tdev.find_batch(pats)
    for p, f, w in zip(pats, found, jdev.find_batch(pats)):
        np.testing.assert_array_equal(f, w)
    assert calls[2:] == ["search_bounds_packed"]


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "pallas"])
@pytest.mark.parametrize("case", CASES[:2], ids=IDS[:2])
def test_matching_stats_byte_leg_equal_jax(monkeypatch, case, use_pallas):
    """``AnalyticsEngine.matching_stats`` under ``REPRO_WORD_COMPARE=byte``
    on the engine of a JAX index carried into the port: equal to JAX's,
    each call one ``search_bounds_packed`` call (the lower bound,
    ``bounds=1``)."""
    alpha, n, mem, packing = case
    a = J_ALPHABETS[alpha]
    monkeypatch.setenv("REPRO_WORD_COMPARE", "byte")
    monkeypatch.setenv("REPRO_KERNELS", "pallas" if use_pallas else "jnp")
    s = a.random_string(n, seed=n + 7)
    s[n // 3:n // 3 + 70] = s[40:110]
    _, jeng = JIndexer(a, JConfig(memory_bytes=mem, build_impl="none")
                       ).build_analytics(s, packing=packing)
    teng = AnalyticsEngine.from_device(
        DeviceIndex.from_blobs(jeng.dev.to_blobs(), device="cpu"),
        jeng.lcp_host)
    assert teng.dev.packed
    rng = np.random.default_rng(n)
    q = np.concatenate([s[30:120], rng.integers(0, len(a.symbols), 50)
                        .astype(np.uint8), s[len(s) - 25:len(s) - 1]])
    calls = []
    real = ops.search_bounds_packed

    def spy(*args, **kw):
        calls.append(kw["bounds"])
        return real(*args, **kw)

    monkeypatch.setattr(ops, "search_bounds_packed", spy)
    for window in (16, 64):
        got = teng.matching_stats(q, window=window)
        want = jeng.matching_stats(q, window=window)
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(x))
    assert calls == [1, 1]


def test_packed_wrappers_check_card_inputs(monkeypatch):
    """The checks a card call makes before any build or launch."""
    monkeypatch.setattr(tsearch, "_on_cpu", lambda *tensors: False)
    _, _, tdev = _index(*CASES[0])
    pt, ell = tdev.s_text, tdev.ell
    pat = torch.zeros((4, 2), dtype=torch.int32)
    lo = torch.zeros(4, dtype=torch.int32)
    bounds = functools.partial(tsearch.search_bounds_packed, pt, ell, pat,
                               pat)
    fetch = functools.partial(tsearch.search_fetch_packed, pt, ell, pat, pat)
    with pytest.raises(ValueError, match="bounds"):
        bounds(lo, lo, n_iter=3, bounds=3)
    with pytest.raises(ValueError, match="n_iter"):
        bounds(lo, lo, n_iter=-1, bounds=1)
    with pytest.raises(ValueError, match="row counts"):
        bounds(lo, lo[:3], n_iter=3, bounds=1)
    with pytest.raises(ValueError, match="contiguous"):
        bounds(torch.zeros(8, dtype=torch.int32)[::2], lo, n_iter=3, bounds=1)
    with pytest.raises(ValueError, match="int32"):
        bounds(lo.long(), lo, n_iter=3, bounds=1)
    with pytest.raises(ValueError, match="empty suffix array"):
        tsearch.search_bounds_packed(pt, ell[:0], pat, pat, lo, lo, n_iter=3,
                                     bounds=1)
    with pytest.raises(ValueError, match="words"):
        tsearch.search_bounds_packed(
            dataclasses.replace(pt, words=pt.words.long()), ell, pat, pat, lo,
            lo, n_iter=3, bounds=1)
    wide = torch.zeros((4, 1024), dtype=torch.int32)
    with pytest.raises(ValueError, match="pack it with a larger extra"):
        tsearch.search_bounds_packed(pt, ell, wide, wide, lo, lo, n_iter=3,
                                     bounds=1)
    for f in (0, 6):
        with pytest.raises(ValueError, match="multiple of 4"):
            fetch(lo, lo, n_iter=3, fetch=f)
    with pytest.raises(ValueError, match="row counts"):
        fetch(lo, lo[:3], n_iter=3, fetch=8)
    with pytest.raises(ValueError, match="pack it with a larger extra"):
        fetch(lo, lo, n_iter=3, fetch=4096)
    with pytest.raises(ValueError, match="empty suffix array"):
        tsearch.search_fetch_packed(pt, ell[:0], pat, pat, lo, lo, n_iter=3,
                                    fetch=8)

"""PyTorch port vs the JAX package: find-and-fetch in one search launch.

``ops.search_fetch`` (through ``DeviceIndex.find_fetch_ranges`` and
directly) on CPU tensors — the plain versions of the fused kernels
``search_fetch_words`` / ``search_fetch_bytes``: ``search_loop`` with the
plain probes, then ``search.fetch_epilogue`` — must equal the JAX
``repro.core.query._find_fetch_batch`` on the same index and batch, with
``use_pallas`` in both settings (Pallas in interpret mode): all four
outputs ``(start, count, window, verified)``.  Cases: dense DNA words and
the protein byte string; batches of 1 and 33 patterns; rows that match
nothing; empty search windows (``lo0 == hi0``, through the JAX search
and epilogue on the same windows); windows running past ``n_real`` (the
terminal patched in); ``fetch`` narrower and wider than the patterns;
patterns of more than 16 words (the kernels' shared-memory row); and the
byte-key route on dense text (a terminal-bearing batch and
``REPRO_WORD_COMPARE=byte``), one ``search_fetch_packed`` call a batch.
Tolerance: exact — every quantity is an integer.
"""

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
from repro_torch.core.query import DeviceIndex
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import search as tsearch

# (alphabet, n, memory_bytes, packing): dense words, then the byte string
DNA = ("dna", 1500, 2048, "auto")
PROTEIN = ("protein", 1000, 4096, "auto")
_INDEXES = {}


def _index(alpha, n, mem, packing):
    """(s, JAX DeviceIndex, port DeviceIndex from its blobs), built once;
    a planted 300-symbol repeat gives long patterns two occurrences."""
    key = (alpha, n, mem, packing)
    if key not in _INDEXES:
        a = J_ALPHABETS[alpha]
        s = a.random_string(n, seed=n + mem + 1)
        s[n - 320:n - 20] = s[40:340]
        cfg = JConfig(memory_bytes=mem, r_bytes=128, build_impl="none")
        jdev = JIndexer(a, cfg).build_device(s, packing=packing)
        _INDEXES[key] = (s, jdev, DeviceIndex.from_blobs(jdev.to_blobs(),
                                                         device="cpu"))
    return _INDEXES[key]


def _patterns(s, n_sym, rng, *, m_max=40, terminal=None):
    """Planted substrings, random codes (mostly absent: count 0), and
    patterns that end at the text's last symbols (their windows run past
    n_real); with ``terminal``, patterns that run into it."""
    n = len(s) - 1
    pats = [np.asarray(s[i:i + m]) for m in (1, 3, 8, 17, m_max)
            for i in rng.integers(0, n - m, 3)]
    pats += [rng.integers(0, n_sym, int(rng.integers(6, 14))).astype(np.uint8)
             for _ in range(8)]
    pats += [np.asarray(s[n - k:n]) for k in (1, 2, 5, 16)]
    if terminal is not None:
        pats += [np.append(s[n - k:n], terminal).astype(np.uint8)
                 for k in (0, 1, 3)]
    return pats


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_equal(got, want):
    assert len(got) == len(want) == 4
    for g, w, part in zip(got, want, ("start", "count", "window",
                                      "verified")):
        assert g.dtype == torch.int32, part
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=part)


def _jax_ranges(jdev, padded, lengths, route, fetch, use_pallas, word):
    return jq._find_fetch_batch(
        jdev.s_text, jdev.ell, jdev.win_lo, jdev.win_hi, jdev.pows,
        jdev.spans, jnp.asarray(padded), jnp.asarray(lengths),
        jnp.asarray(route), k_route=jdev.k_route, n_iter=jdev.n_iter,
        use_pallas=use_pallas, word=word, fetch=fetch)


@functools.lru_cache(maxsize=None)
def _jax_fetch_windows(n_iter, use_pallas, word, fetch):
    """The body of JAX ``_find_fetch_batch`` after routing, on windows the
    caller gives: its search, its fused epilogue and its decode."""

    def run(s_text, ell, pat, mask, lengths, lo0, hi0):
        llo, ulo = jq._search_bounds(s_text, ell, pat, mask, lengths, lo0,
                                     hi0, n_iter=n_iter,
                                     use_pallas=use_pallas, word=word)
        count = jnp.maximum(ulo - llo, 0)
        pos0 = ell[jnp.clip(llo, 0, ell.shape[0] - 1)]
        if word:
            cmp, win = jops.probe_gather_words_impl(use_pallas)(
                s_text, pos0, pat, mask, lengths, fetch)
        else:
            cmp, win = jops.probe_gather_impl(use_pallas)(
                s_text, pos0, pat, mask, fetch)
        sym = jq._window_symbols(s_text, win, pos0, fetch, word)
        return llo, count, jnp.where((count > 0)[:, None], sym, -1), cmp

    return jax.jit(run)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "pallas"])
@pytest.mark.parametrize("case", [DNA, PROTEIN], ids=["dna", "protein"])
def test_find_fetch_ranges_equal_jax(case, use_pallas):
    """Routed windows, fetch 32: planted, absent and end-of-text patterns;
    the port's ``find_fetch_ranges`` runs ``search_fetch`` once."""
    s, jdev, tdev = _index(*case)
    a = J_ALPHABETS[case[0]]
    rng = np.random.default_rng(1)
    padded, lengths, route = jdev.pad_batch(_patterns(s, len(a.symbols), rng))
    word = case is DNA
    got = tdev.find_fetch_ranges(padded, lengths, route, fetch=32)
    _assert_equal(got, _jax_ranges(jdev, padded, lengths, route, 32,
                                   use_pallas, word))
    count, win = got[1].numpy(), got[2].numpy()
    assert (count == 0).any() and (count > 0).any()
    assert (win[count == 0] == -1).all()
    # a window that runs past n_real ends in the terminal
    pos0 = tdev.ell_host[np.clip(got[0].numpy(), 0, tdev.n_leaves - 1)]
    past = (pos0 + 32 > len(s) - 1) & (count > 0)
    assert past.any() and (win[past, -1] == a.terminal_code).all()


@pytest.mark.parametrize("b", [1, 33])
@pytest.mark.parametrize("case", [DNA, PROTEIN], ids=["dna", "protein"])
def test_find_fetch_ranges_batch_sizes(case, b):
    """A batch of one pattern, and of 33 (an odd count: the kernels' last
    warp holds a half-filled set of lane pairs)."""
    s, jdev, tdev = _index(*case)
    a = J_ALPHABETS[case[0]]
    rng = np.random.default_rng(b)
    pats = _patterns(s, len(a.symbols), rng)
    pats = [pats[int(i)] for i in rng.integers(0, len(pats), b)]
    padded, lengths, route = jdev.pad_batch(pats)
    got = tdev.find_fetch_ranges(padded, lengths, route, fetch=16)
    assert got[2].shape == (b, 16)
    _assert_equal(got, _jax_ranges(jdev, padded, lengths, route, 16, False,
                                   case is DNA))


@pytest.mark.parametrize("kind,fetch", [("empty", 4), ("mixed", 64),
                                        ("unrouted", 8)])
@pytest.mark.parametrize("case", [DNA, PROTEIN], ids=["dna", "protein"])
def test_search_fetch_windows_equal_jax(case, kind, fetch):
    """``ops.search_fetch`` on windows given directly — all empty (lo0 ==
    hi0: no trip runs, the epilogue reads at the clamped lo0), a mix of
    routed, unrouted and empty ones, and all unrouted — against the JAX
    search, epilogue and decode on the same windows; fetch narrower (4,
    8) and wider (64) than the patterns."""
    s, jdev, tdev = _index(*case)
    a = J_ALPHABETS[case[0]]
    word = case is DNA
    rng = np.random.default_rng(fetch)
    padded, lengths, route = jdev.pad_batch(_patterns(s, len(a.symbols), rng))
    lo0, hi0 = (np.asarray(x) for x in jq._route_window(
        jdev.win_lo, jdev.win_hi, jdev.pows, jdev.spans,
        jnp.asarray(lengths), jnp.asarray(route), jdev.k_route))
    b, total = len(lengths), jdev.n_leaves
    empty = rng.integers(0, total + 1, b).astype(np.int32)
    if kind == "empty":
        lo0 = hi0 = empty
    elif kind == "unrouted":
        lo0, hi0 = np.zeros(b, np.int32), np.full(b, total, np.int32)
    else:
        pick = rng.integers(0, 3, b)
        lo0 = np.choose(pick, [lo0, np.zeros(b, np.int32), empty])
        hi0 = np.choose(pick, [hi0, np.full(b, total, np.int32), empty])
    lo0, hi0 = lo0.astype(np.int32), hi0.astype(np.int32)
    pat_j, mask_j = jq._pack_query_batch(jdev.s_text, jnp.asarray(padded),
                                         jnp.asarray(lengths), word)
    want = _jax_fetch_windows(jdev.n_iter, False, word, fetch)(
        jdev.s_text, jdev.ell, pat_j, mask_j, jnp.asarray(lengths),
        jnp.asarray(lo0), jnp.asarray(hi0))
    pat, mask = tq._pack_query_batch(tdev.s_text, _t(padded), _t(lengths),
                                     word)
    got = ops.search_fetch(tdev.s_text, tdev.ell, pat, mask, _t(lengths),
                           _t(lo0), _t(hi0), n_iter=tdev.n_iter, fetch=fetch,
                           word=word)
    _assert_equal(got, want)
    if kind == "empty":
        assert (got[1].numpy() == 0).all() and (got[2].numpy() == -1).all()
        np.testing.assert_array_equal(got[0].numpy(), lo0)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "pallas"])
@pytest.mark.parametrize("case,m", [(DNA, 272), (PROTEIN, 72)],
                         ids=["dna", "protein"])
def test_find_fetch_wide_patterns_equal_jax(case, m, use_pallas):
    """Patterns of more than 16 words (DNA 17 words of 16 symbols, byte
    keys 18 words of 4): the kernels stage such rows in shared memory."""
    s, jdev, tdev = _index(*case)
    a = J_ALPHABETS[case[0]]
    rng = np.random.default_rng(m)
    pats = [np.asarray(s[i:i + m - int(d)]) for i, d in zip(
        [40, 41, 500, len(s) - 1 - m], rng.integers(0, 8, 4))]
    pats.append(rng.integers(0, len(a.symbols), m).astype(np.uint8))
    padded, lengths, route = jdev.pad_batch(pats, m_pad=m)
    got = tdev.find_fetch_ranges(padded, lengths, route, fetch=32)
    _assert_equal(got, _jax_ranges(jdev, padded, lengths, route, 32,
                                   use_pallas, case is DNA))
    assert got[1].numpy()[0] == 2  # the planted repeat


def test_fetch_byte_keys_on_dense_text(monkeypatch):
    """A terminal-bearing batch on a dense index, and every batch under
    ``REPRO_WORD_COMPARE=byte``, take the byte-key route: one
    ``search_fetch_packed`` call a batch (search, verdict and decoded
    window), equal to JAX, and never the fused word kernel nor the loop of
    ``pattern_probe_packed`` steps and ``probe_gather_packed``."""
    s, jdev, tdev = _index(*DNA)
    a = J_ALPHABETS["dna"]
    rng = np.random.default_rng(5)
    calls = []
    for name in ("search_fetch_words", "search_fetch_bytes",
                 "search_fetch_packed", "pattern_probe_packed",
                 "probe_gather_packed"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *x, _r=real, _n=name, **k: (
            calls.append(_n), _r(*x, **k))[1])
    term = _patterns(s, len(a.symbols), rng, terminal=a.terminal_code)
    padded, lengths, route = jdev.pad_batch(term)
    got = tdev.find_fetch_ranges(padded, lengths, route, fetch=32)
    _assert_equal(got, _jax_ranges(jdev, padded, lengths, route, 32, False,
                                   False))
    assert calls == ["search_fetch_packed"]
    monkeypatch.setenv("REPRO_WORD_COMPARE", "byte")
    padded, lengths, route = jdev.pad_batch(_patterns(s, len(a.symbols),
                                                      rng))
    got = tdev.find_fetch_ranges(padded, lengths, route, fetch=16)
    _assert_equal(got, _jax_ranges(jdev, padded, lengths, route, 16, True,
                                   False))
    assert calls == ["search_fetch_packed"] * 2


@pytest.mark.parametrize("case", [DNA, PROTEIN], ids=["dna", "protein"])
def test_find_fetch_ranges_is_one_search_fetch_call(monkeypatch, case):
    """Word rows and the byte string take their fused wrapper once a batch
    and none of the search or epilogue wrappers it replaces."""
    s, _, tdev = _index(*case)
    fused = "search_fetch_words" if case is DNA else "search_fetch_bytes"
    calls = []
    for name in (fused, "search_bounds_words", "search_bounds_bytes",
                 "probe_gather_words", "pattern_probe",
                 "range_gather_pack"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *x, _r=real, _n=name, **k: (
            calls.append(_n), _r(*x, **k))[1])
    tdev.find_fetch_batch([s[10:20], s[100:104]], fetch=8)
    assert calls == [fused]


@pytest.mark.parametrize("word", [True, False], ids=["words", "bytes"])
def test_window_symbols_equal_jax(word):
    """The decode alone, on random words (sign bits set) at positions
    around ``n_real`` of a dense text."""
    _, jdev, tdev = _index(*DNA)
    rng = np.random.default_rng(2)
    fetch = 24
    nw = -(-fetch // (16 if word else 4))
    win = rng.integers(0, 1 << 32, (40, nw), dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    pos0 = rng.integers(tdev.s_text.n_real - 40, tdev.s_text.n_real + 1,
                        40).astype(np.int32)
    want = jq._window_symbols(jdev.s_text, jnp.asarray(win),
                              jnp.asarray(pos0), fetch, word)
    got = tref.window_symbols_ref(tdev.s_text, _t(win), _t(pos0), fetch,
                                  word)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_search_fetch_wrappers_check_card_inputs(monkeypatch):
    """The checks a card call makes before any build or launch."""
    monkeypatch.setattr(tsearch, "_on_cpu", lambda *tensors: False)
    _, _, bdev = _index(*PROTEIN)
    _, _, wdev = _index(*DNA)
    pat = torch.zeros((4, 2), dtype=torch.int32)
    lo = torch.zeros(4, dtype=torch.int32)
    for fetch in (0, 6):
        with pytest.raises(ValueError, match="multiple of 4"):
            tsearch.search_fetch_bytes(bdev.s_text, bdev.ell, pat, pat, lo,
                                       lo, n_iter=3, fetch=fetch)
    with pytest.raises(ValueError, match="row counts"):
        tsearch.search_fetch_bytes(bdev.s_text, bdev.ell, pat, pat, lo,
                                   lo[:3], n_iter=3, fetch=8)
    with pytest.raises(ValueError, match="uint8"):
        tsearch.search_fetch_bytes(bdev.ell, bdev.ell, pat, pat, lo, lo,
                                   n_iter=3, fetch=8)
    with pytest.raises(ValueError, match="row counts"):
        tsearch.search_fetch_words(wdev.s_text, wdev.ell, pat, pat, lo[:2],
                                   lo, lo, n_iter=3, fetch=8)
    with pytest.raises(ValueError, match="empty suffix array"):
        tsearch.search_fetch_words(wdev.s_text, wdev.ell[:0], pat, pat, lo,
                                   lo, lo, n_iter=3, fetch=8)
    with pytest.raises(ValueError, match="words"):
        tsearch.search_fetch_words(wdev.s_text, wdev.ell, pat, pat, lo, lo,
                                   lo, n_iter=3, fetch=4096)


@pytest.mark.parametrize("case", [DNA, PROTEIN], ids=["dna", "protein"])
def test_search_fetch_empty_batch(case):
    """A batch of no patterns gives four empty outputs of the right
    shapes (the kernels launch nothing for it)."""
    _, _, tdev = _index(*case)
    word = case is DNA
    nw = 2 if word else 4
    pat = torch.zeros((0, nw), dtype=torch.int32)
    none = torch.zeros(0, dtype=torch.int32)
    got = ops.search_fetch(tdev.s_text, tdev.ell, pat, pat, none, none, none,
                           n_iter=tdev.n_iter, fetch=12, word=word)
    assert [tuple(g.shape) for g in got] == [(0,), (0,), (0, 12), (0,)]
    assert all(g.dtype == torch.int32 for g in got)

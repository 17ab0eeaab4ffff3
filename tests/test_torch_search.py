"""PyTorch port vs the JAX package: the search kernels' plain versions.

``ops.search_bounds_words`` and ``ops.search_bounds_bytes`` on CPU tensors
(``search_loop`` with the plain probes, the path a CPU tensor takes) must
equal the JAX ``repro.core.query._search_bounds`` on the same packed rows
and windows, with ``use_pallas`` in both settings (Pallas in interpret
mode): routed, unrouted (``[0, total)``, every trip runs) and empty
windows, patterns that end at the text's terminal tail, on dense DNA,
protein-class and 8-bit words and on the protein, english, byte and
``packing="bytes"`` strings.  The lower-bound-only search (``bounds=1``)
with a pattern limit below the compare length must equal the JAX
``_matching_stats`` loop, directly and through
``AnalyticsEngine.matching_stats``.  The port runs on the CPU.
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
from repro_torch.core.analytics import AnalyticsEngine
from repro_torch.core.query import DeviceIndex
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import search as tsearch

# (alphabet, n, memory_bytes, packing): word path first, then byte strings
WORD_CASES = [("dna", 1500, 2048, "auto"),
              ("protein_class", 900, 4096, "auto"),
              ("protein", 800, 4096, "dense")]
BYTE_CASES = [("protein", 1000, 4096, "auto"), ("english", 900, 4096, "auto"),
              ("byte", 700, 4096, "auto"), ("dna", 900, 2048, "bytes")]
WINDOWS = ["routed", "unrouted", "empty", "mixed"]
_INDEXES = {}


def _index(alpha, n, mem, packing):
    """(s, JAX DeviceIndex, port DeviceIndex from its blobs), built once."""
    key = (alpha, n, mem, packing)
    if key not in _INDEXES:
        a = J_ALPHABETS[alpha]
        s = a.random_string(n, seed=n + mem)
        s[n // 2:n // 2 + 60] = s[20:80]  # a planted repeat: long matches
        cfg = JConfig(memory_bytes=mem, r_bytes=128, build_impl="none")
        jdev = JIndexer(a, cfg).build_device(s, packing=packing)
        _INDEXES[key] = (s, jdev, DeviceIndex.from_blobs(jdev.to_blobs(),
                                                         device="cpu"))
    return _INDEXES[key]


def _patterns(s, n_sym, terminal, rng, *, with_terminal: bool):
    """Planted substrings (long ones included), random codes, and patterns
    that end at the text's last symbols (and, on byte strings, run into
    the terminal)."""
    n = len(s) - 1
    pats = []
    for m in (1, 2, 3, 5, 8, 13, 21, 40):
        for _ in range(3):
            i = int(rng.integers(0, n - m))
            pats.append(np.asarray(s[i:i + m]))
    pats += [rng.integers(0, n_sym, size=int(rng.integers(1, 12)))
             .astype(np.uint8) for _ in range(10)]
    pats += [np.asarray(s[n - k:n]) for k in (1, 2, 4, 7, 16)]
    if with_terminal:
        pats += [np.concatenate([s[n - k:n], [terminal]]).astype(np.uint8)
                 for k in (0, 1, 3, 9)]
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


def _batch(case, kind, seed, *, word):
    """(s, jdev, tdev, padded, lengths, route, lo0, hi0) of one batch."""
    alpha, n, mem, packing = case
    s, jdev, tdev = _index(*case)
    a = J_ALPHABETS[alpha]
    rng = np.random.default_rng(seed)
    pats = _patterns(s, len(a.symbols), a.terminal_code, rng,
                     with_terminal=not word)
    padded, lengths, route = jdev.pad_batch(pats)
    lo0, hi0 = jq._route_window(jdev.win_lo, jdev.win_hi, jdev.pows,
                                jdev.spans, jnp.asarray(lengths),
                                jnp.asarray(route), jdev.k_route)
    lo0, hi0 = _windows(kind, np.asarray(lo0), np.asarray(hi0),
                        jdev.n_leaves, rng)
    return s, jdev, tdev, padded, lengths, route, lo0, hi0


def _port_rows(tdev, padded, lengths, word):
    return tq._pack_query_batch(tdev.s_text, torch.from_numpy(padded),
                                torch.from_numpy(lengths), word)


@functools.lru_cache(maxsize=None)
def _jax_search(n_iter, use_pallas, word):
    return jax.jit(functools.partial(jq._search_bounds, n_iter=n_iter,
                                     use_pallas=use_pallas, word=word))


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "pallas"])
@pytest.mark.parametrize("kind", WINDOWS)
@pytest.mark.parametrize("case", WORD_CASES + BYTE_CASES,
                         ids=lambda c: f"{c[0]}-{c[3]}")
def test_search_bounds_equal_jax(case, kind, use_pallas):
    word = case in WORD_CASES
    s, jdev, tdev, padded, lengths, _, lo0, hi0 = _batch(case, kind, 3,
                                                         word=word)
    pat_j, mask_j = jq._pack_query_batch(jdev.s_text, jnp.asarray(padded),
                                         jnp.asarray(lengths), word)
    llo, ulo = _jax_search(jdev.n_iter, use_pallas, word)(
        jdev.s_text, jdev.ell, pat_j, mask_j, jnp.asarray(lengths),
        jnp.asarray(lo0), jnp.asarray(hi0))
    pat, mask = _port_rows(tdev, padded, lengths, word)
    np.testing.assert_array_equal(pat.numpy().view(np.uint32),
                                  np.asarray(pat_j).view(np.uint32))
    t = lambda x: torch.from_numpy(np.array(x))
    if word:
        got = ops.search_bounds_words(tdev.s_text, tdev.ell, pat, mask,
                                      t(lengths), None, t(lo0), t(hi0),
                                      n_iter=tdev.n_iter, bounds=2)
    else:
        got = ops.search_bounds_bytes(tdev.s_text, tdev.ell, pat, mask,
                                      t(lo0), t(hi0), n_iter=tdev.n_iter,
                                      bounds=2)
    assert got.dtype == torch.int32 and got.shape == (2, len(lengths))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(llo))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ulo))
    if kind == "empty":
        np.testing.assert_array_equal(got[0].numpy(), lo0)
    # bounds=1 is the lower bound alone
    if word:
        low = ops.search_bounds_words(tdev.s_text, tdev.ell, pat, mask,
                                      t(lengths), t(lengths), t(lo0), t(hi0),
                                      n_iter=tdev.n_iter, bounds=1)
    else:
        low = ops.search_bounds_bytes(tdev.s_text, tdev.ell, pat, mask,
                                      t(lo0), t(hi0), n_iter=tdev.n_iter,
                                      bounds=1)
    assert low.shape == (1, len(lengths))
    np.testing.assert_array_equal(low[0].numpy(), np.asarray(llo))


@pytest.mark.parametrize("case", [WORD_CASES[0], BYTE_CASES[0]],
                         ids=["dna", "protein"])
def test_search_bounds_find_all_occurrences(case):
    """Through ``find_batch_ranges`` (routed windows, both bounds from one
    call): every pattern's slice of ``ell`` holds exactly its occurrences."""
    s, jdev, tdev, padded, lengths, route, _, _ = _batch(
        case, "routed", 5, word=case in WORD_CASES)
    start, count = tdev.find_batch_ranges(padded, lengths, route)
    js, jc = jdev.find_batch_ranges(padded, lengths, route)
    np.testing.assert_array_equal(start.numpy(), np.asarray(js))
    np.testing.assert_array_equal(count.numpy(), np.asarray(jc))
    n = len(s)
    for row, (st, c, m) in enumerate(zip(start.tolist(), count.tolist(),
                                         lengths.tolist())):
        p = padded[row, :m]
        want = [i for i in range(n - m + 1) if np.array_equal(s[i:i + m], p)]
        assert sorted(tdev.ell_host[st:st + c].tolist()) == want


def _jax_lower_bound(jdev, pat, mask, w_arr, lim_p, lo0, hi0, use_pallas):
    """The lower-bound loop of ``repro.core.analytics._matching_stats``
    (word path: the window's first terminal as the pattern limit)."""
    probe_w = jops.pattern_probe_words_impl(use_pallas)
    total = jdev.ell.shape[0]

    def body(_, st):
        lo, hi = st
        mid = (lo + hi) // 2
        pos = jdev.ell[jnp.clip(mid, 0, total - 1)]
        cmp = probe_w(jdev.s_text, pos, pat, mask, w_arr, lim_p)
        act = lo < hi
        return (jnp.where(act & (cmp < 0), mid + 1, lo),
                jnp.where(act & (cmp >= 0), mid, hi))

    return jax.lax.fori_loop(0, jdev.n_iter, body, (lo0, hi0))[0]


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "pallas"])
@pytest.mark.parametrize("case", WORD_CASES, ids=lambda c: c[0])
def test_lower_bound_with_pattern_limit_equal_jax(case, use_pallas):
    """``bounds=1`` with ``lim_p < lengths``: windows of query symbols
    followed by terminal padding, as matching statistics searches them."""
    alpha = case[0]
    s, jdev, tdev = _index(*case)
    a = J_ALPHABETS[alpha]
    rng = np.random.default_rng(11)
    w = 24
    q = np.concatenate([s[100:160], rng.integers(0, len(a.symbols), 40)
                        .astype(np.uint8), s[len(s) - 30:len(s) - 1]])
    n_q = len(q)
    q_ext = np.concatenate([q, np.full(w, a.terminal_code, np.uint8)])
    windows = np.stack([q_ext[i:i + w] for i in range(n_q)]).astype(np.int32)
    bits = jdev.s_text.bits
    pat_j = jq.packing_mod.pack_pattern_dense(jnp.asarray(windows), bits,
                                              jdev.s_text.terminal)
    mask_j = jnp.broadcast_to(jq.packing_mod.pack_dense(
        jnp.full((1, w), (1 << bits) - 1, jnp.int32), bits), pat_j.shape)
    lim_p = np.clip(n_q - np.arange(n_q), 0, w).astype(np.int32)
    w_arr = np.full(n_q, w, np.int32)
    lo0 = rng.integers(0, jdev.n_leaves // 2, n_q).astype(np.int32)
    hi0 = np.where(rng.random(n_q) < 0.5, jdev.n_leaves,
                   lo0 + rng.integers(0, 40, n_q)).astype(np.int32)
    want = _jax_lower_bound(jdev, pat_j, mask_j, jnp.asarray(w_arr),
                            jnp.asarray(lim_p), jnp.asarray(lo0),
                            jnp.asarray(hi0), use_pallas)
    t = lambda x: torch.from_numpy(np.array(x).view(np.int32))
    got = ops.search_bounds_words(tdev.s_text, tdev.ell, t(pat_j), t(mask_j),
                                  t(w_arr), t(lim_p), t(lo0), t(hi0),
                                  n_iter=tdev.n_iter, bounds=1)
    assert (lim_p < w).any()
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "pallas"])
@pytest.mark.parametrize("case", [WORD_CASES[0], BYTE_CASES[0],
                                  BYTE_CASES[2]],
                         ids=["dna", "protein", "byte"])
def test_matching_stats_equal_jax(monkeypatch, case, use_pallas):
    """``AnalyticsEngine.matching_stats`` on the engine of a JAX index
    carried into the port: equal to JAX's, with the lower-bound search
    going through the search kernels' wrappers (``bounds=1``)."""
    alpha, n, mem, packing = case
    a = J_ALPHABETS[alpha]
    s = a.random_string(n, seed=n + 7)
    s[n // 3:n // 3 + 70] = s[40:110]
    _, jeng = JIndexer(a, JConfig(memory_bytes=mem, build_impl="none")
                       ).build_analytics(s, packing=packing)
    teng = AnalyticsEngine.from_device(
        DeviceIndex.from_blobs(jeng.dev.to_blobs(), device="cpu"),
        jeng.lcp_host)
    rng = np.random.default_rng(n)
    q = np.concatenate([s[30:120], rng.integers(0, len(a.symbols), 50)
                        .astype(np.uint8), s[len(s) - 25:len(s) - 1]])
    calls = []
    name = ("search_bounds_words" if teng.dev.packed
            else "search_bounds_bytes")
    real = getattr(ops, name)

    def spy(*args, **kw):
        calls.append(kw["bounds"])
        return real(*args, **kw)

    monkeypatch.setattr(ops, name, spy)
    monkeypatch.setenv("REPRO_KERNELS", "pallas" if use_pallas else "jnp")
    for window in (16, 64):
        got = teng.matching_stats(q, window=window)
        want = jeng.matching_stats(q, window=window)
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(x))
    assert calls and set(calls) == {1}


@pytest.mark.parametrize("bounds", [1, 2])
def test_search_loop_with_counted_probe_is_one_call_per_trip(bounds):
    """The loop calls its probe ``n_iter`` times on ``bounds * B`` rows,
    and rows whose window is empty never move."""
    s, jdev, tdev = _index(*WORD_CASES[0])
    padded, lengths, _ = tdev.pad_batch([s[10:20], s[40:43], s[5:6]])
    pat, mask = _port_rows(tdev, padded, lengths, True)
    lens = torch.from_numpy(lengths)
    seen = []

    def probe(*args):
        seen.append(args[1].shape[0])
        return tref.pattern_probe_words_ref(*args)

    lo0 = torch.tensor([0, 7, 7], dtype=torch.int32)
    hi0 = torch.tensor([tdev.n_leaves, 7, tdev.n_leaves], dtype=torch.int32)
    out = tsearch.search_loop(probe, tdev.s_text, tdev.ell, pat, mask, lens,
                              lens, lo0, hi0, n_iter=tdev.n_iter,
                              bounds=bounds)
    assert seen == [bounds * 3] * tdev.n_iter
    assert out.shape == (bounds, 3) and int(out[0, 1]) == 7
    if bounds == 2:
        assert int(out[1, 1]) == 7 and bool((out[1] >= out[0]).all())


def test_search_wrappers_check_card_inputs(monkeypatch):
    """The checks a card call makes before any build or launch."""
    monkeypatch.setattr(tsearch, "_on_cpu", lambda *tensors: False)
    s, _, tdev = _index(*BYTE_CASES[0])
    pat = torch.zeros((4, 2), dtype=torch.int32)
    lo = torch.zeros(4, dtype=torch.int32)
    ell = tdev.ell
    call = functools.partial(tsearch.search_bounds_bytes, tdev.s_text, ell,
                             pat, pat)
    with pytest.raises(ValueError, match="bounds"):
        call(lo, lo, n_iter=3, bounds=3)
    with pytest.raises(ValueError, match="n_iter"):
        call(lo, lo, n_iter=-1, bounds=1)
    with pytest.raises(ValueError, match="row counts"):
        call(lo, lo[:3], n_iter=3, bounds=1)
    with pytest.raises(ValueError, match="contiguous"):
        call(torch.zeros(8, dtype=torch.int32)[::2], lo, n_iter=3, bounds=1)
    with pytest.raises(ValueError, match="int32"):
        call(lo.long(), lo, n_iter=3, bounds=1)
    with pytest.raises(ValueError, match="empty suffix array"):
        tsearch.search_bounds_bytes(tdev.s_text, ell[:0], pat, pat, lo, lo,
                                    n_iter=3, bounds=1)
    _, _, wdev = _index(*WORD_CASES[0])
    with pytest.raises(ValueError, match="row counts"):
        tsearch.search_bounds_words(wdev.s_text, wdev.ell, pat, pat, lo[:2],
                                    None, lo, lo, n_iter=3, bounds=2)
    with pytest.raises(ValueError, match="uint8"):
        tsearch.search_bounds_bytes(ell, ell, pat, pat, lo, lo, n_iter=3,
                                    bounds=1)

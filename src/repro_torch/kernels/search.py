"""The binary search over the suffix array: one kernel launch per search.

* :func:`search_loop` — the fixed-trip lower/upper bound search written out
  as a loop of ``n_iter`` probe calls (the JAX ``fori_loop`` of
  ``repro.core.query._search_bounds`` and ``repro.core.analytics.
  _matching_stats``).  With the plain probes it is the plain version of
  the search kernels; with the single-step kernels it is the yardstick
  they are timed against.
* :func:`search_bounds_words` — ``csrc/search_bounds_words.cu``: the whole
  search of masked dense pattern rows (the loop around
  ``repro/kernels/packed_gather.py:pattern_probe_words``) in one launch.
* :func:`search_bounds_bytes` — ``csrc/search_bounds_bytes.cu``: the same
  on the terminal-padded uint8 string (the loop around
  ``repro/kernels/pattern_probe.py:pattern_probe``).
* :func:`search_bounds_packed` — ``csrc/search_bounds_packed.cu``: the
  same for byte-key rows over the dense text (the loop around
  ``repro/kernels/packed_gather.py:pattern_probe_packed``: a batch that
  carries the terminal code, and ``REPRO_WORD_COMPARE=byte``).

All three return a ``(bounds, B)`` int32 tensor: row 0 the lower bounds
(first suffix >= the pattern), row 1, when ``bounds == 2``, the upper
bounds (first suffix > it), indices into ``ell``.

* :func:`search_fetch_words` — ``csrc/search_fetch_words.cu``: the whole
  find-and-fetch of ``repro.core.query._find_fetch_batch`` on dense words
  (the search, then ``repro/kernels/probe_gather.py:probe_gather_words``
  at each lower bound and the window decode) in one launch.
* :func:`search_fetch_bytes` — ``csrc/search_fetch_bytes.cu``: the same on
  the terminal-padded uint8 string (the search, then ``pattern_probe`` and
  ``range_gather_pack`` at each lower bound and the decode).
* :func:`search_fetch_packed` — ``csrc/search_fetch_packed.cu``: the same
  for byte-key rows over the dense text (the search, then
  ``repro/kernels/probe_gather.py:probe_gather_packed`` at each lower
  bound and the decode).

All three return ``(start, count, window, verified)`` as
:func:`fetch_epilogue` does; their plain version is
:func:`fetch_composition`: :func:`search_loop` then that epilogue, with
the plain probes.  CUDA tensors launch the
kernel (or raise), CPU tensors run the plain version.  Each wrapper
counts its launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.packing import PackedText, _sub_word
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.packed_gather import (
    _check_extra,
    _on_cpu,
    _require,
    _stream,
    _t_word,
    pattern_probe_packed,
)
from repro_torch.kernels.pattern_probe import pattern_probe
from repro_torch.kernels.probe_gather import (
    probe_gather_packed,
    probe_gather_words,
)
from repro_torch.kernels.range_gather import range_gather_pack, require_byte_text

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_U32 = ctypes.c_uint


def search_loop(probe, s_text, ell: torch.Tensor, pat: torch.Tensor,
                mask: torch.Tensor, lengths: torch.Tensor | None,
                lim_p: torch.Tensor | None, lo0: torch.Tensor,
                hi0: torch.Tensor, *, n_iter: int,
                bounds: int) -> torch.Tensor:
    """Fixed-trip binary search of ``bounds`` × B rows, one ``probe`` call
    per trip; returns (bounds, B) int32 bounds into ``ell``.

    Row r searches pattern r mod B in ``[lo0, hi0)``: rows < B for the
    lower bound (``cmp < 0 → lo = mid + 1``, else ``hi = mid``), rows >= B
    for the upper bound (``cmp <= 0 → lo = mid + 1``); a row with
    ``lo >= hi`` stays as it is.  ``probe(s_text, pos, pat, mask,
    [lengths, lim_p])`` gives the verdicts; ``lengths`` and ``lim_p`` are
    the word probe's compare lengths and pattern limits (``lim_p`` None:
    ``lengths``), both None for the byte-key probes.
    """
    if bounds not in (1, 2):
        raise ValueError(f"bounds must be 1 or 2, got {bounds}")
    b = pat.shape[0]
    total = ell.shape[0]
    rep = lambda t: t if bounds == 1 else torch.cat([t, t])
    pat2, mask2 = rep(pat), rep(mask)
    extra = () if lengths is None else (
        rep(lengths), rep(lengths if lim_p is None else lim_p))
    lo, hi = rep(lo0), rep(hi0)
    upper = torch.arange(bounds * b, device=lo.device) >= b
    for _ in range(n_iter):
        mid = (lo + hi) // 2
        cmp = probe(s_text, ell[torch.clamp(mid, 0, total - 1)], pat2, mask2,
                    *extra)
        act = lo < hi
        # lower bound: first suffix >= pattern (prefix match counts as >=);
        # upper bound: first suffix > pattern
        right = torch.where(upper, cmp <= 0, cmp < 0)
        lo, hi = (torch.where(act & right, mid + 1, lo),
                  torch.where(act & ~right, mid, hi))
    return lo.reshape(bounds, b)


def _check_search(ell, pat, mask, lo0, hi0, n_iter: int, bounds: int) -> None:
    """Shapes and dtypes of a search batch on the card."""
    if bounds not in (1, 2):
        raise ValueError(f"bounds must be 1 or 2, got {bounds}")
    if n_iter < 0:
        raise ValueError(f"n_iter must be >= 0, got {n_iter}")
    _require(ell, "ell", torch.int32, 1)
    _require(pat, "pat", torch.int32, 2)
    _require(mask, "mask", torch.int32, 2)
    _require(lo0, "lo0", torch.int32, 1)
    _require(hi0, "hi0", torch.int32, 1)
    b = pat.shape[0]
    if mask.shape != pat.shape or lo0.shape[0] != b or hi0.shape[0] != b:
        raise ValueError("search: row counts disagree")
    if ell.shape[0] == 0:
        raise ValueError("search: empty suffix array")


def search_bounds_words(pt: PackedText, ell: torch.Tensor,
                        pat_dense: torch.Tensor, mask_dense: torch.Tensor,
                        lengths: torch.Tensor, lim_p: torch.Tensor | None,
                        lo0: torch.Tensor, hi0: torch.Tensor, *, n_iter: int,
                        bounds: int) -> torch.Tensor:
    """(bounds, B) int32 lower (and upper) bounds of masked dense pattern
    rows in ``[lo0, hi0)`` of ``ell`` — bit-identical to
    :func:`search_loop` with
    :func:`repro_torch.kernels.ref.pattern_probe_words_ref`.

    pat_dense / mask_dense: (B, NW) int32 dense rows; lengths: int32[B]
    compare lengths; lim_p: the pattern side's first-terminal index
    (None: ``lengths``, no terminal in the pattern).
    """
    if lim_p is None:
        lim_p = lengths
    if _on_cpu(pt.words, ell, pat_dense, mask_dense, lengths, lim_p, lo0,
               hi0):
        return search_loop(_ref.pattern_probe_words_ref, pt, ell, pat_dense,
                           mask_dense, lengths, lim_p, lo0, hi0,
                           n_iter=n_iter, bounds=bounds)
    _require(pt.words, "words", torch.int32, 1)
    _check_search(ell, pat_dense, mask_dense, lo0, hi0, n_iter, bounds)
    _require(lengths, "lengths", torch.int32, 1)
    _require(lim_p, "lim_p", torch.int32, 1)
    b, nw = pat_dense.shape
    if lengths.shape[0] != b or lim_p.shape[0] != b:
        raise ValueError("search_bounds_words: row counts disagree")
    _check_extra(pt, nw * pt.syms_per_word)
    out = torch.empty((bounds, b), dtype=torch.int32, device=ell.device)
    if b == 0:
        return out
    fn = _build.entry("search_bounds_words",
                      [_P, _I64, _P, _I64, _P, _P, _P, _P, _P, _P, _I64,
                       _I32, _I32, _I32, _I32, _I64, _U32, _P, _P])
    with torch.cuda.device(ell.device):
        rc = fn(pt.words.data_ptr(), pt.words.shape[0], ell.data_ptr(),
                ell.shape[0], pat_dense.data_ptr(), mask_dense.data_ptr(),
                lengths.data_ptr(), lim_p.data_ptr(), lo0.data_ptr(),
                hi0.data_ptr(), b, bounds, nw, n_iter, pt.bits, pt.n_real,
                _sub_word(pt.bits, pt.terminal), out.data_ptr(),
                _stream(ell.device))
    _build.check(rc, "search_bounds_words")
    search_bounds_words.launches += 1
    return out


search_bounds_words.launches = 0


def search_bounds_bytes(s_padded: torch.Tensor, ell: torch.Tensor,
                        pat_words: torch.Tensor, mask_words: torch.Tensor,
                        lo0: torch.Tensor, hi0: torch.Tensor, *, n_iter: int,
                        bounds: int) -> torch.Tensor:
    """(bounds, B) int32 lower (and upper) bounds of masked byte-key
    pattern rows in ``[lo0, hi0)`` of ``ell`` over the terminal-padded
    uint8 string — bit-identical to :func:`search_loop` with
    :func:`repro_torch.kernels.ref.pattern_probe_ref`.

    pat_words / mask_words: (B, W) int32 byte-packed pattern rows and
    0xFF-byte masks.
    """
    if _on_cpu(s_padded, ell, pat_words, mask_words, lo0, hi0):
        return search_loop(_ref.pattern_probe_ref, s_padded, ell, pat_words,
                           mask_words, None, None, lo0, hi0, n_iter=n_iter,
                           bounds=bounds)
    require_byte_text(s_padded)
    _check_search(ell, pat_words, mask_words, lo0, hi0, n_iter, bounds)
    b, nw = pat_words.shape
    out = torch.empty((bounds, b), dtype=torch.int32, device=ell.device)
    if b == 0:
        return out
    fn = _build.entry("search_bounds_bytes",
                      [_P, _I64, _P, _I64, _P, _P, _P, _P, _I64, _I32, _I32,
                       _I32, _P, _P])
    with torch.cuda.device(ell.device):
        rc = fn(s_padded.data_ptr(), s_padded.shape[0], ell.data_ptr(),
                ell.shape[0], pat_words.data_ptr(), mask_words.data_ptr(),
                lo0.data_ptr(), hi0.data_ptr(), b, bounds, nw, n_iter,
                out.data_ptr(), _stream(ell.device))
    _build.check(rc, "search_bounds_bytes")
    search_bounds_bytes.launches += 1
    return out


search_bounds_bytes.launches = 0


def search_bounds_packed(pt: PackedText, ell: torch.Tensor,
                         pat_words: torch.Tensor, mask_words: torch.Tensor,
                         lo0: torch.Tensor, hi0: torch.Tensor, *, n_iter: int,
                         bounds: int) -> torch.Tensor:
    """(bounds, B) int32 lower (and upper) bounds of masked byte-key
    pattern rows in ``[lo0, hi0)`` of ``ell`` over the dense text —
    bit-identical to :func:`search_loop` with
    :func:`repro_torch.kernels.ref.pattern_probe_packed_ref` (and so to the
    byte-key search on the terminal-padded string).

    pat_words / mask_words: (B, W) int32 byte-packed pattern rows and
    0xFF-byte masks.
    """
    if _on_cpu(pt.words, ell, pat_words, mask_words, lo0, hi0):
        return search_loop(_ref.pattern_probe_packed_ref, pt, ell, pat_words,
                           mask_words, None, None, lo0, hi0, n_iter=n_iter,
                           bounds=bounds)
    _require(pt.words, "words", torch.int32, 1)
    _check_search(ell, pat_words, mask_words, lo0, hi0, n_iter, bounds)
    b, nw = pat_words.shape
    _check_extra(pt, 4 * nw)
    out = torch.empty((bounds, b), dtype=torch.int32, device=ell.device)
    if b == 0:
        return out
    fn = _build.entry("search_bounds_packed",
                      [_P, _I64, _P, _I64, _P, _P, _P, _P, _I64, _I32, _I32,
                       _I32, _I32, _I64, _U32, _P, _P])
    with torch.cuda.device(ell.device):
        rc = fn(pt.words.data_ptr(), pt.words.shape[0], ell.data_ptr(),
                ell.shape[0], pat_words.data_ptr(), mask_words.data_ptr(),
                lo0.data_ptr(), hi0.data_ptr(), b, bounds, nw, n_iter,
                pt.bits, pt.n_real, _t_word(pt), out.data_ptr(),
                _stream(ell.device))
    _build.check(rc, "search_bounds_packed")
    search_bounds_packed.launches += 1
    return out


search_bounds_packed.launches = 0


def fetch_epilogue(s_text, ell: torch.Tensor, bnd: torch.Tensor,
                   probe_gather, *, fetch: int, word: bool):
    """The find-and-fetch epilogue of ``repro.core.query._find_fetch_batch``
    after its search: ``bnd`` holds the (2, B) lower and upper bounds,
    ``probe_gather(pos0) -> (cmp, win)`` gives the verdict and the raw
    window at each lower-bound suffix ``pos0 = ell[clamp(llo)]``.  Returns
    ``(start, count, window, verified)``: start = llo, count = max(ulo −
    llo, 0), window the (B, fetch) int32 codes of
    :func:`repro_torch.kernels.ref.window_symbols_ref` (−1 rows where
    count == 0), verified the verdict (0 where count > 0)."""
    llo, ulo = bnd[0], bnd[1]
    count = torch.clamp(ulo - llo, min=0)
    pos0 = ell[torch.clamp(llo, 0, ell.shape[0] - 1)]
    cmp, win = probe_gather(pos0)
    sym = _ref.window_symbols_ref(s_text, win, pos0, fetch, word)
    return (llo, count,
            torch.where((count > 0)[:, None], sym, -1).to(torch.int32), cmp)


def fetch_composition(s_text, ell: torch.Tensor, pat: torch.Tensor,
                      mask: torch.Tensor, lengths: torch.Tensor | None,
                      lo0: torch.Tensor, hi0: torch.Tensor, *, n_iter: int,
                      fetch: int, word: bool, plain: bool = True):
    """What the fused search kernels compute, as the composition they
    replace: both bounds, then :func:`fetch_epilogue` at the lower bounds.
    ``plain``: with the plain probes (the fused kernels' plain version, on
    any device); else with the ported kernels launched one after the
    other — ``search_bounds_words`` then ``probe_gather_words`` on dense
    words, ``search_bounds_bytes`` then ``pattern_probe`` +
    ``range_gather_pack`` on the byte string, and for byte keys on a dense
    :class:`PackedText` the loop of ``pattern_probe_packed`` steps then
    ``probe_gather_packed`` — the yardstick the fused kernels are timed
    against."""
    args = (s_text, ell, pat, mask)
    if word:
        if plain:
            bnd = search_loop(_ref.pattern_probe_words_ref, *args, lengths,
                              None, lo0, hi0, n_iter=n_iter, bounds=2)
            gather = lambda pos: _ref.probe_gather_words_ref(
                s_text, pos, pat, mask, lengths, fetch=fetch)
        else:
            bnd = search_bounds_words(*args, lengths, None, lo0, hi0,
                                      n_iter=n_iter, bounds=2)
            gather = lambda pos: probe_gather_words(s_text, pos, pat, mask,
                                                    lengths, fetch)
    elif isinstance(s_text, PackedText):
        probe = _ref.pattern_probe_packed_ref if plain else pattern_probe_packed
        bnd = search_loop(probe, *args, None, None, lo0, hi0, n_iter=n_iter,
                          bounds=2)
        if plain:
            gather = lambda pos: _ref.probe_gather_packed_ref(
                s_text, pos, pat, mask, fetch=fetch)
        else:
            gather = lambda pos: probe_gather_packed(s_text, pos, pat, mask,
                                                     fetch)
    elif plain:
        bnd = search_loop(_ref.pattern_probe_ref, *args, None, None, lo0,
                          hi0, n_iter=n_iter, bounds=2)
        gather = lambda pos: (_ref.pattern_probe_ref(s_text, pos, pat, mask),
                              _ref.range_gather_pack_ref(s_text, pos, fetch))
    else:
        bnd = search_bounds_bytes(*args, lo0, hi0, n_iter=n_iter, bounds=2)
        gather = lambda pos: (pattern_probe(s_text, pos, pat, mask),
                              range_gather_pack(s_text, pos, fetch))
    return fetch_epilogue(s_text, ell, bnd, gather, fetch=fetch, word=word)


def _check_fetch(fetch: int) -> None:
    if fetch <= 0 or fetch % 4:
        raise ValueError(f"fetch={fetch} must be a positive multiple of 4")


def _fetch_outputs(b: int, fetch: int, device: torch.device):
    """``(start, count, window, verified)`` as views of one int32 buffer
    (one allocation a batch): the window first, so its rows of ``fetch``
    codes (a multiple of 4) are 16-byte aligned for the kernel's stores."""
    window, start, count, verified = torch.empty(
        b * (fetch + 3), dtype=torch.int32, device=device).split(
            (b * fetch, b, b, b))
    return start, count, window.view(b, fetch), verified


def search_fetch_words(pt: PackedText, ell: torch.Tensor,
                       pat_dense: torch.Tensor, mask_dense: torch.Tensor,
                       lengths: torch.Tensor, lo0: torch.Tensor,
                       hi0: torch.Tensor, *, n_iter: int, fetch: int):
    """Find-and-fetch of masked dense pattern rows in ``[lo0, hi0)`` of
    ``ell`` in one launch: ``(start, count, window, verified)``,
    bit-identical to :func:`fetch_composition` (``word=True``: the search
    with :func:`repro_torch.kernels.ref.pattern_probe_words_ref`, then
    :func:`repro_torch.kernels.ref.probe_gather_words_ref` at the lower
    bounds).  ``lengths`` are the compare lengths and the pattern limits
    (no terminal in the pattern)."""
    _check_fetch(fetch)
    if _on_cpu(pt.words, ell, pat_dense, mask_dense, lengths, lo0, hi0):
        return fetch_composition(pt, ell, pat_dense, mask_dense, lengths, lo0,
                                 hi0, n_iter=n_iter, fetch=fetch, word=True)
    _require(pt.words, "words", torch.int32, 1)
    _check_search(ell, pat_dense, mask_dense, lo0, hi0, n_iter, 2)
    _require(lengths, "lengths", torch.int32, 1)
    b, nw = pat_dense.shape
    if lengths.shape[0] != b:
        raise ValueError("search_fetch_words: row counts disagree")
    _check_extra(pt, max(nw * pt.syms_per_word, fetch))
    start, count, window, verified = _fetch_outputs(b, fetch, ell.device)
    if b == 0:
        return start, count, window, verified
    fn = _build.entry("search_fetch_words",
                      [_P, _I64, _P, _I64, _P, _P, _P, _P, _P, _I64, _I32,
                       _I32, _I32, _I64, _U32, _I32, _I32, _P, _P, _P, _P,
                       _P])
    with torch.cuda.device(ell.device):
        rc = fn(pt.words.data_ptr(), pt.words.shape[0], ell.data_ptr(),
                ell.shape[0], pat_dense.data_ptr(), mask_dense.data_ptr(),
                lengths.data_ptr(), lo0.data_ptr(), hi0.data_ptr(), b, nw,
                n_iter, pt.bits, pt.n_real, _sub_word(pt.bits, pt.terminal),
                pt.terminal, fetch, start.data_ptr(), count.data_ptr(),
                window.data_ptr(), verified.data_ptr(), _stream(ell.device))
    _build.check(rc, "search_fetch_words")
    search_fetch_words.launches += 1
    return start, count, window, verified


search_fetch_words.launches = 0


def search_fetch_bytes(s_padded: torch.Tensor, ell: torch.Tensor,
                       pat_words: torch.Tensor, mask_words: torch.Tensor,
                       lo0: torch.Tensor, hi0: torch.Tensor, *, n_iter: int,
                       fetch: int):
    """Find-and-fetch of masked byte-key pattern rows in ``[lo0, hi0)`` of
    ``ell`` over the terminal-padded uint8 string in one launch: ``(start,
    count, window, verified)``, bit-identical to :func:`fetch_composition`
    (``word=False``: the search with
    :func:`repro_torch.kernels.ref.pattern_probe_ref`, then
    ``pattern_probe_ref`` and ``range_gather_pack_ref`` at the lower
    bounds)."""
    _check_fetch(fetch)
    if _on_cpu(s_padded, ell, pat_words, mask_words, lo0, hi0):
        return fetch_composition(s_padded, ell, pat_words, mask_words, None,
                                 lo0, hi0, n_iter=n_iter, fetch=fetch,
                                 word=False)
    require_byte_text(s_padded)
    _check_search(ell, pat_words, mask_words, lo0, hi0, n_iter, 2)
    b, nw = pat_words.shape
    start, count, window, verified = _fetch_outputs(b, fetch, ell.device)
    if b == 0:
        return start, count, window, verified
    fn = _build.entry("search_fetch_bytes",
                      [_P, _I64, _P, _I64, _P, _P, _P, _P, _I64, _I32, _I32,
                       _I32, _P, _P, _P, _P, _P])
    with torch.cuda.device(ell.device):
        rc = fn(s_padded.data_ptr(), s_padded.shape[0], ell.data_ptr(),
                ell.shape[0], pat_words.data_ptr(), mask_words.data_ptr(),
                lo0.data_ptr(), hi0.data_ptr(), b, nw, n_iter, fetch,
                start.data_ptr(), count.data_ptr(), window.data_ptr(),
                verified.data_ptr(), _stream(ell.device))
    _build.check(rc, "search_fetch_bytes")
    search_fetch_bytes.launches += 1
    return start, count, window, verified


search_fetch_bytes.launches = 0


def search_fetch_packed(pt: PackedText, ell: torch.Tensor,
                        pat_words: torch.Tensor, mask_words: torch.Tensor,
                        lo0: torch.Tensor, hi0: torch.Tensor, *, n_iter: int,
                        fetch: int):
    """Find-and-fetch of masked byte-key pattern rows in ``[lo0, hi0)`` of
    ``ell`` over the dense text in one launch: ``(start, count, window,
    verified)``, bit-identical to :func:`fetch_composition` (``word=False``
    on a :class:`PackedText`: the search with
    :func:`repro_torch.kernels.ref.pattern_probe_packed_ref`, then
    :func:`repro_torch.kernels.ref.probe_gather_packed_ref` at the lower
    bounds and the decode, the terminal patched in past ``n_real``)."""
    _check_fetch(fetch)
    if _on_cpu(pt.words, ell, pat_words, mask_words, lo0, hi0):
        return fetch_composition(pt, ell, pat_words, mask_words, None, lo0,
                                 hi0, n_iter=n_iter, fetch=fetch, word=False)
    _require(pt.words, "words", torch.int32, 1)
    _check_search(ell, pat_words, mask_words, lo0, hi0, n_iter, 2)
    b, nw = pat_words.shape
    _check_extra(pt, max(4 * nw, fetch))
    start, count, window, verified = _fetch_outputs(b, fetch, ell.device)
    if b == 0:
        return start, count, window, verified
    fn = _build.entry("search_fetch_packed",
                      [_P, _I64, _P, _I64, _P, _P, _P, _P, _I64, _I32, _I32,
                       _I32, _I64, _U32, _I32, _P, _P, _P, _P, _P])
    with torch.cuda.device(ell.device):
        rc = fn(pt.words.data_ptr(), pt.words.shape[0], ell.data_ptr(),
                ell.shape[0], pat_words.data_ptr(), mask_words.data_ptr(),
                lo0.data_ptr(), hi0.data_ptr(), b, nw, n_iter, pt.bits,
                pt.n_real, _t_word(pt), fetch, start.data_ptr(),
                count.data_ptr(), window.data_ptr(), verified.data_ptr(),
                _stream(ell.device))
    _build.check(rc, "search_fetch_packed")
    search_fetch_packed.launches += 1
    return start, count, window, verified


search_fetch_packed.launches = 0

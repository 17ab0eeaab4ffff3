"""Plain PyTorch versions of the port's hand-written CUDA kernels.

Each function here computes exactly what its kernel computes.  All but
:func:`flash_attention_ref` are integer kernels, so every comparison
against them is exact; attention sums floats in another order than its
kernel, and its comparisons state their tolerance.  The
kernel wrappers run them for tensors that lie on the CPU, the CPU tests
hold them against the JAX package, and ``chip_smoke.py`` holds each kernel
against its plain version on the card.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.packing import (  # noqa: F401  (shared implementations)
    PACK_SHIFTS,
    PackedText,
    extract_sym,
    flip_sign,
    gather_pack,
    gather_pack_dense,
    gather_words_dense,
    lcp_words,
    lcp_words_limited,
    to_i32,
    word_limit,
)


def _masked(keys: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    return keys if mask is None else torch.where(mask[:, None], keys, 0)


def range_gather_words_ref(pt: PackedText, offs: torch.Tensor, w: int,
                           mask: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`gather_words_dense`, rows whose ``mask`` is False zeroed."""
    return _masked(gather_words_dense(pt, offs, w), mask)


def range_gather_pack_ref(s_padded: torch.Tensor, offs: torch.Tensor, w: int,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`gather_pack`, rows whose ``mask`` is False zeroed."""
    return _masked(gather_pack(s_padded, offs, w), mask)


def range_gather_packed_ref(pt: PackedText, offs: torch.Tensor, w: int,
                            mask: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`gather_pack_dense`, rows whose ``mask`` is False zeroed."""
    return _masked(gather_pack_dense(pt, offs, w), mask)


def probe_compare_ref(sw: torch.Tensor, pat_words: torch.Tensor) -> torch.Tensor:
    """Sign of masked suffix key rows against pattern rows, compared
    unsigned at the first differing word (shared tail of the byte-key
    probes, ``repro.kernels.ref.probe_compare_ref``)."""
    nw = sw.shape[1]
    neq = sw != pat_words
    iota = torch.arange(nw, device=sw.device)
    first = torch.clamp(torch.where(neq, iota, nw).amin(dim=1), max=nw - 1)
    a = torch.take_along_dim(sw, first[:, None], dim=1)[:, 0]
    b = torch.take_along_dim(pat_words, first[:, None], dim=1)[:, 0]
    lt = flip_sign(a) < flip_sign(b)  # unsigned compare (byte codes >= 128)
    return torch.where(neq.any(dim=1), torch.where(lt, -1, 1),
                       0).to(torch.int32)


def pattern_probe_ref(s_padded: torch.Tensor, pos: torch.Tensor,
                      pat_words: torch.Tensor,
                      mask_words: torch.Tensor) -> torch.Tensor:
    """−1/0/+1 per row: the masked byte keys of the suffix at ``pos``
    against the packed pattern row (0: the suffix starts with the
    pattern) — ``repro.kernels.ref.pattern_probe_ref``."""
    w = pat_words.shape[1] * 4
    sw = range_gather_pack_ref(s_padded, pos, w) & mask_words
    return probe_compare_ref(sw, pat_words)


def pattern_probe_packed_ref(pt: PackedText, pos: torch.Tensor,
                             pat_words: torch.Tensor,
                             mask_words: torch.Tensor) -> torch.Tensor:
    """:func:`pattern_probe_ref` reading the dense text: the byte keys are
    repacked from the dense words, so the verdicts equal the byte probe's
    (``repro.kernels.ref.pattern_probe_packed_ref``)."""
    w = pat_words.shape[1] * 4
    sw = range_gather_packed_ref(pt, pos, w) & mask_words
    return probe_compare_ref(sw, pat_words)


def lcp_pairs_ref(a: torch.Tensor, b: torch.Tensor, w: int):
    """(lcp, c1, c2) int32[F] of (F, W) byte-key rows: the first differing
    byte (symbol) index capped at ``w``, and that byte of each row; fully
    equal rows give lcp == w and c1 == c2 == 0
    (``repro.kernels.ref.lcp_pairs_ref``)."""
    f, nw = a.shape
    shifts = torch.tensor(PACK_SHIFTS, device=a.device)
    ab = ((a.to(torch.int64)[:, :, None] >> shifts) & 0xFF).reshape(f, nw * 4)
    bb = ((b.to(torch.int64)[:, :, None] >> shifts) & 0xFF).reshape(f, nw * 4)
    neq = ab != bb
    iota = torch.arange(nw * 4, device=a.device)
    first = torch.where(neq, iota, nw * 4).amin(dim=1)
    sel = iota == first[:, None]
    c1 = torch.where(sel, ab, 0).sum(dim=1)
    c2 = torch.where(sel, bb, 0).sum(dim=1)
    lcp = torch.clamp(first, max=w)
    return lcp.to(torch.int32), c1.to(torch.int32), c2.to(torch.int32)


def probe_words_ref(sw: torch.Tensor, pat_words: torch.Tensor,
                    lim_s: torch.Tensor, lim_p: torch.Tensor,
                    cmp_len: torch.Tensor, bits: int) -> torch.Tensor:
    """Word-compare probe verdict (``repro.kernels.ref.probe_words_ref``).

    sw / pat_words: (B, NW) substituted dense rows, both masked to the
    per-row compare length; lim_s / lim_p: per-row terminal limits.  A
    difference below both in-range limits decides by its symbols;
    otherwise the side whose limit falls inside the compared region is
    larger; limits at or past ``cmp_len`` never participate.
    """
    spw = 32 // bits
    nw = sw.shape[-1]
    big = nw * spw
    lim_s = lim_s.to(torch.int64)
    lim_p = lim_p.to(torch.int64)
    cmp_len = cmp_len.to(torch.int64)
    ls = torch.where(lim_s < cmp_len, lim_s, big)
    lp = torch.where(lim_p < cmp_len, lim_p, big)
    p = lcp_words(sw, pat_words, bits).to(torch.int64)
    idx = torch.clamp(p, 0, big - 1)
    ca = extract_sym(sw, idx, bits)
    cb = extract_sym(pat_words, idx, bits)
    sym_sign = torch.where(ca < cb, -1, 1)
    lim_sign = torch.where(ls < lp, 1, torch.where(lp < ls, -1, 0))
    return torch.where(p < torch.minimum(ls, lp), sym_sign,
                       lim_sign).to(torch.int32)


def pattern_probe_words_ref(pt: PackedText, pos: torch.Tensor,
                            pat_dense: torch.Tensor, mask_dense: torch.Tensor,
                            lengths: torch.Tensor,
                            lim_p: torch.Tensor | None = None) -> torch.Tensor:
    """−1/0/+1 per row: the masked suffix at ``pos`` against a dense
    pattern row (``repro.kernels.ref.pattern_probe_words_ref``)."""
    w = pat_dense.shape[1] * (32 // pt.bits)
    sw = range_gather_words_ref(pt, pos, w) & mask_dense
    lim_s = pt.n_real - pos.to(torch.int64)
    if lim_p is None:
        lim_p = lengths
    return probe_words_ref(sw, pat_dense, lim_s, lim_p, lengths, pt.bits)


def probe_gather_words_ref(pt: PackedText, pos: torch.Tensor,
                           pat_dense: torch.Tensor, mask_dense: torch.Tensor,
                           lengths: torch.Tensor,
                           lim_p: torch.Tensor | None = None, *,
                           fetch: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(cmp int32[B], win int32[B, ceil(fetch/spw)]): by definition the
    two-launch composition :func:`pattern_probe_words_ref` then
    :func:`range_gather_words_ref` at the same positions, which the fused
    kernel must match bit for bit (``repro.kernels.ref.probe_gather_words_ref``)."""
    cmp = pattern_probe_words_ref(pt, pos, pat_dense, mask_dense, lengths,
                                  lim_p)
    return cmp, range_gather_words_ref(pt, pos, fetch)


def probe_gather_packed_ref(pt: PackedText, pos: torch.Tensor,
                            pat_words: torch.Tensor, mask_words: torch.Tensor,
                            *, fetch: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(cmp int32[B], keys int32[B, fetch//4]): the two-launch composition
    :func:`pattern_probe_packed_ref` then :func:`range_gather_packed_ref`
    (``repro.kernels.ref.probe_gather_packed_ref``)."""
    cmp = pattern_probe_packed_ref(pt, pos, pat_words, mask_words)
    return cmp, range_gather_packed_ref(pt, pos, fetch)


def window_symbols_ref(s_text, win: torch.Tensor, pos0: torch.Tensor,
                       fetch: int, word: bool) -> torch.Tensor:
    """A fetched window decoded to (B, fetch) int32 symbol codes
    (``repro.core.query._window_symbols``): word rows hold ``bits``-wide
    fields of int32 words (uint32 bit patterns: the arithmetic shift's
    sign bits fall outside the field mask, C1), byte-key rows four
    big-endian bytes.  A dense text substitutes ``sub_code`` past
    ``n_real``, so the true terminal is patched back in by position: the
    window is the same for every storage and leg.  The fused search
    kernels compute this decode in registers."""
    b = win.shape[0]
    dev = win.device
    if word:
        bits, spw = s_text.bits, s_text.syms_per_word
        shifts = 32 - bits * (torch.arange(spw, device=dev) + 1)
        sym = (win[:, :, None] >> shifts) & ((1 << bits) - 1)
    else:
        shifts = 24 - 8 * torch.arange(4, device=dev)
        sym = (win[:, :, None] >> shifts) & 0xFF
    sym = sym.reshape(b, sym.shape[1] * sym.shape[2])[:, :fetch]
    sym = sym.to(torch.int32)
    if isinstance(s_text, PackedText):
        past = (pos0.to(torch.int64)[:, None]
                + torch.arange(fetch, device=dev)[None, :] >= s_text.n_real)
        sym = torch.where(past, s_text.terminal, sym).to(torch.int32)
    return sym


def suffix_lcp_words_ref(pt: PackedText, pos_a: torch.Tensor,
                         pos_b: torch.Tensor, w: int) -> torch.Tensor:
    """int32[B] LCP of dense suffix pairs: first differing word by XOR,
    the symbol by count-leading-zeros, capped at ``w`` and at both
    terminal limits (``repro.kernels.ref.suffix_lcp_words_ref``)."""
    a = range_gather_words_ref(pt, pos_a, w)
    b = range_gather_words_ref(pt, pos_b, w)
    la = word_limit(pt.n_real, pos_a, w)
    lb = word_limit(pt.n_real, pos_b, w)
    return lcp_words_limited(a, b, la, lb, w, pt.bits)


def suffix_lcp_pairs_ref(s_padded: torch.Tensor, pos_a: torch.Tensor,
                         pos_b: torch.Tensor, w: int) -> torch.Tensor:
    """int32[B] first unequal symbol of two suffixes of a byte string
    within ``w`` (else ``w``): both reads packed to byte keys, every symbol
    index clamped to ``len(s_padded) - 1``, then the row LCP
    (``repro.kernels.ref.suffix_lcp_pairs_ref``)."""
    a = range_gather_pack_ref(s_padded, pos_a, w)
    b = range_gather_pack_ref(s_padded, pos_b, w)
    return lcp_pairs_ref(a, b, w)[0]


def kmer_histogram_ref(s: torch.Tensor, n: int, k: int,
                       base: int) -> torch.Tensor:
    """Counts of every base-``base`` k-mer code over windows 0..n-1, as a
    ``bincount`` of the rolling codes.  ``s`` must hold at least
    ``n + k - 1`` symbols.  Returns int32[base**k]."""
    codes = torch.zeros(n, dtype=torch.int64, device=s.device)
    for d in range(k):
        codes = codes * base + s[d:d + n].to(torch.int64)
    return torch.bincount(codes, minlength=base**k).to(torch.int32)


def pack_text_dense_ref(codes: torch.Tensor, n_words: int,
                        bits: int) -> torch.Tensor:
    """int32[n_words] dense words of the uint8 ``codes`` (each below
    ``1 << bits``), ``32 // bits`` symbols a word big-endian, zero past
    the codes: the words of :func:`repro_torch.core.packing.pack_text`."""
    spw = 32 // bits
    grp = torch.zeros(n_words * spw, dtype=torch.uint8, device=codes.device)
    grp[:codes.shape[0]] = codes
    grp = grp.view(n_words, spw)
    words = torch.zeros(n_words, dtype=torch.int64, device=codes.device)
    for k in range(spw):  # one field at a time keeps the peak small
        words |= grp[:, k].to(torch.int64) << (32 - bits * (k + 1))
    return to_i32(words)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """(B, Sq, H, D) attention of q (B, Sq, H, D) over k/v (B, Sk, KV, D)
    with GQA (query head h reads KV head ``h // (H // KV)``), scale
    1/sqrt(D), row i seeing keys j <= i when ``causal``: the einsum/softmax
    of ``tests/test_flash_and_packed.py:ref_attn``, in float32 (float64
    for float64 inputs) with the mask value -1e30, cast back to
    ``q.dtype``."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    ct = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(b, sq, kv, h // kv, d).to(ct)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.to(ct)) / math.sqrt(d)
    if causal:
        rows = torch.arange(sq, device=q.device)
        mask = rows[:, None] >= torch.arange(sk, device=q.device)[None, :]
        logits = torch.where(mask, logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.to(ct))
    return out.reshape(b, sq, h, d).to(q.dtype)

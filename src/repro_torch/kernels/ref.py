"""Plain PyTorch versions of the port's hand-written CUDA kernels.

Each function here computes exactly what its kernel computes (all three
are integer kernels, so every comparison against them is exact).  The
kernel wrappers run them for tensors that lie on the CPU, the CPU tests
hold them against the JAX package, and ``chip_smoke.py`` holds each kernel
against its plain version on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.packing import (  # noqa: F401  (shared implementations)
    PackedText,
    extract_sym,
    gather_words_dense as range_gather_words_ref,
    lcp_words,
)


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


def kmer_histogram_ref(s: torch.Tensor, n: int, k: int,
                       base: int) -> torch.Tensor:
    """Counts of every base-``base`` k-mer code over windows 0..n-1, as a
    ``bincount`` of the rolling codes.  ``s`` must hold at least
    ``n + k - 1`` symbols.  Returns int32[base**k]."""
    codes = torch.zeros(n, dtype=torch.int64, device=s.device)
    for d in range(k):
        codes = codes * base + s[d:d + n].to(torch.int64)
    return torch.bincount(codes, minlength=base**k).to(torch.int32)

"""Kernel dispatch for the port (counterpart of ``repro.kernels.ops``).

Dispatch goes by the device of the tensors a call is given, never by a
knob: a CUDA tensor always reaches the hand-written kernel (a build or
launch failure raises), a CPU tensor runs the kernel's plain version.
Entry points therefore choose the path through their ``device`` argument
(:func:`resolve_device`), which defaults to ``"cuda"`` and refuses to run
silently on the CPU when the card is missing.

The construction and search knobs keep the JAX package's names and
meanings, so one CI leg covers both packages:

* ``REPRO_WORD_COMPARE=word`` (default) — dense words are the compare
  currency of a dense text; ``byte`` pins the byte-key oracle ON DENSE
  TEXT: construction reads byte keys from the dense words
  (``range_gather_packed``) and sorts and compares them as on byte text,
  searches run a loop of ``pattern_probe_packed`` steps (find-and-fetch
  through ``probe_gather_packed`` after the loop), and
  suffix-pair LCPs run ``range_gather_packed`` + ``lcp_pairs``.  A
  byte-per-symbol text (protein, english, byte, ``packing="bytes"``)
  always runs the byte-key currency (``range_gather_pack``,
  ``lcp_pairs``, ``search_bounds_bytes``, ``search_fetch_bytes``,
  ``suffix_lcp_pairs``), and a dense index answers a batch carrying the
  terminal code through ``pattern_probe_packed``, as the JAX package
  does.  Searches on dense words run ``search_bounds_words``,
  find-and-fetch ``search_fetch_words``;
* ``REPRO_SORT=fused|lexsort`` — fused single-lane sort keys or the
  multi-key oracle sort;
* ``REPRO_COMPACT=tail|off`` — tail compaction of the elastic step.
"""

from __future__ import annotations

import os

import torch

from repro_torch.core.packing import PackedText
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.kmer_histogram import kmer_histogram
from repro_torch.kernels.lcp import lcp_pairs
from repro_torch.kernels.packed_gather import (
    pattern_probe_packed,
    pattern_probe_words,
    range_gather_packed,
    range_gather_words,
    suffix_lcp_words,
)
from repro_torch.kernels.pattern_probe import pattern_probe
from repro_torch.kernels.probe_gather import (
    probe_gather_packed,
    probe_gather_words,
)
from repro_torch.kernels.range_gather import range_gather_pack
from repro_torch.kernels.search import (
    fetch_epilogue,
    search_bounds_bytes,
    search_bounds_words,
    search_fetch_bytes,
    search_fetch_words,
    search_loop,
)
from repro_torch.kernels.suffix_lcp import suffix_lcp_pairs as _suffix_lcp_bytes

KERNELS = {
    "range_gather_words": range_gather_words,
    "pattern_probe_words": pattern_probe_words,
    "kmer_histogram": kmer_histogram,
    "range_gather_pack": range_gather_pack,
    "lcp_pairs": lcp_pairs,
    "pattern_probe": pattern_probe,
    "pattern_probe_packed": pattern_probe_packed,
    "range_gather_packed": range_gather_packed,
    "suffix_lcp_words": suffix_lcp_words,
    "suffix_lcp_pairs": _suffix_lcp_bytes,
    "probe_gather_words": probe_gather_words,
    "probe_gather_packed": probe_gather_packed,
    "flash_attention": flash_attention,
    "search_bounds_words": search_bounds_words,
    "search_bounds_bytes": search_bounds_bytes,
    "search_fetch_words": search_fetch_words,
    "search_fetch_bytes": search_fetch_bytes,
}

__all__ = ["KERNELS", "flash_attention", "kmer_histogram", "launch_counts",
           "lcp_pairs", "pattern_probe", "pattern_probe_packed",
           "pattern_probe_words", "probe_gather", "probe_gather_packed",
           "probe_gather_words",
           "range_gather", "range_gather_pack", "range_gather_packed",
           "range_gather_words", "reset_launch_counts", "resolve_device",
           "search_bounds", "search_bounds_bytes", "search_bounds_words",
           "search_fetch", "search_fetch_bytes", "search_fetch_words",
           "search_loop",
           "suffix_lcp_pairs", "suffix_lcp_words"]


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, per kernel (plain-version calls not counted)."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    """Zero every launch count (and the row and word tallies of the three
    elastic-range gathers and of ``suffix_lcp_words``)."""
    for fn in KERNELS.values():
        fn.launches = 0
    for fn in (range_gather_words, range_gather_pack, range_gather_packed):
        fn.rows = fn.words = 0
    suffix_lcp_words.rows = suffix_lcp_words.words_read = 0


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; a CUDA device without a card
    raises instead of letting the caller run on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev


def range_gather(s_text, offs: torch.Tensor, w: int,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """(F, w//4) byte sort keys at each offset, dispatched on the text
    (``repro.kernels.ops.range_gather_impl``): ``range_gather_packed`` for
    a dense :class:`PackedText`, ``range_gather_pack`` for the
    terminal-padded byte string — identical keys either way.  Rows whose
    ``mask`` is False are zero, in either kernel."""
    if isinstance(s_text, PackedText):
        return range_gather_packed(s_text, offs, w, mask)
    return range_gather_pack(s_text, offs, w, mask)


def probe_gather(s_text, pos: torch.Tensor, pat_words: torch.Tensor,
                 mask_words: torch.Tensor, fetch: int):
    """Find-and-fetch in the byte-key currency, dispatched on the text as
    ``repro.kernels.ops.probe_gather_impl``: ``(cmp int32[B], keys
    int32[B, fetch//4])``.  A dense :class:`PackedText` runs the fused
    ``probe_gather_packed`` kernel; the terminal-padded byte string runs
    the two launches ``pattern_probe`` + ``range_gather_pack`` (the fused
    kernels' definition, so the results are the same for either storage;
    find-and-fetch runs both inside ``search_fetch_bytes``)."""
    if isinstance(s_text, PackedText):
        return probe_gather_packed(s_text, pos, pat_words, mask_words, fetch)
    return (pattern_probe(s_text, pos, pat_words, mask_words),
            range_gather_pack(s_text, pos, fetch))


def search_bounds(s_text, ell: torch.Tensor, pat: torch.Tensor,
                  mask: torch.Tensor, lengths: torch.Tensor,
                  lim_p: torch.Tensor | None, lo0: torch.Tensor,
                  hi0: torch.Tensor, *, n_iter: int, bounds: int,
                  word: bool) -> torch.Tensor:
    """(bounds, B) int32 lower (and upper) bounds of pattern rows in
    ``[lo0, hi0)`` of ``ell``, dispatched on the text and the compare
    currency: one ``search_bounds_words`` launch for dense word rows, one
    ``search_bounds_bytes`` launch on the terminal-padded byte string, and
    for byte keys on a dense :class:`PackedText` (a terminal-bearing batch,
    or ``REPRO_WORD_COMPARE=byte``) the loop of ``n_iter``
    ``pattern_probe_packed`` steps.  ``lengths`` and ``lim_p`` feed the
    word compare only."""
    if word:
        return search_bounds_words(s_text, ell, pat, mask, lengths, lim_p,
                                   lo0, hi0, n_iter=n_iter, bounds=bounds)
    if isinstance(s_text, PackedText):
        return search_loop(pattern_probe_packed, s_text, ell, pat, mask, None,
                           None, lo0, hi0, n_iter=n_iter, bounds=bounds)
    return search_bounds_bytes(s_text, ell, pat, mask, lo0, hi0,
                               n_iter=n_iter, bounds=bounds)


def search_fetch(s_text, ell: torch.Tensor, pat: torch.Tensor,
                 mask: torch.Tensor, lengths: torch.Tensor, lo0: torch.Tensor,
                 hi0: torch.Tensor, *, n_iter: int, fetch: int, word: bool):
    """Find-and-fetch of pattern rows in ``[lo0, hi0)`` of ``ell``
    (``repro.core.query._find_fetch_batch`` after packing and routing):
    ``(start, count, window, verified)``, dispatched as
    :func:`search_bounds`: one ``search_fetch_words`` launch for dense word
    rows, one ``search_fetch_bytes`` launch on the terminal-padded byte
    string, and for byte keys on a dense :class:`PackedText` the loop of
    ``n_iter`` ``pattern_probe_packed`` steps, one ``probe_gather_packed``
    launch and the window decode.  ``lengths`` feed the word compare
    only."""
    if word:
        return search_fetch_words(s_text, ell, pat, mask, lengths, lo0, hi0,
                                  n_iter=n_iter, fetch=fetch)
    if isinstance(s_text, PackedText):
        bnd = search_loop(pattern_probe_packed, s_text, ell, pat, mask, None,
                          None, lo0, hi0, n_iter=n_iter, bounds=2)
        return fetch_epilogue(
            s_text, ell, bnd, lambda pos: probe_gather(
                s_text, pos, pat, mask, fetch), fetch=fetch, word=False)
    return search_fetch_bytes(s_text, ell, pat, mask, lo0, hi0, n_iter=n_iter,
                              fetch=fetch)


def suffix_lcp_pairs(s_text, pos_a: torch.Tensor, pos_b: torch.Tensor,
                     w: int) -> torch.Tensor:
    """int32[B] LCP of suffix pairs capped at ``w``, branch for branch as
    ``repro.kernels.ops.suffix_lcp_pairs``: on a dense text the word
    kernel (``suffix_lcp_words``) or, under ``REPRO_WORD_COMPARE=byte``,
    two byte-key gathers and ``lcp_pairs``; on a byte string the
    ``suffix_lcp_pairs`` kernel."""
    if isinstance(s_text, PackedText):
        if _use_word_compare():
            return suffix_lcp_words(s_text, pos_a, pos_b, w)
        a = range_gather_packed(s_text, pos_a, w)
        b = range_gather_packed(s_text, pos_b, w)
        return lcp_pairs(a, b, w)[0]
    return _suffix_lcp_bytes(s_text, pos_a, pos_b, w)


def _use_word_compare() -> bool:
    env = os.environ.get("REPRO_WORD_COMPARE", "")
    if env in ("", "word"):
        return True
    if env == "byte":
        return False
    raise ValueError(
        f"unknown REPRO_WORD_COMPARE={env!r}; choose 'word' or 'byte'")


def _use_sort_fuse() -> bool:
    env = os.environ.get("REPRO_SORT", "")
    if env == "lexsort":
        return False
    if env in ("", "fused"):
        return True
    raise ValueError(
        f"unknown REPRO_SORT={env!r}; choose 'fused' or 'lexsort'")


def _use_compaction() -> bool:
    env = os.environ.get("REPRO_COMPACT", "")
    if env == "off":
        return False
    if env in ("", "tail"):
        return True
    raise ValueError(
        f"unknown REPRO_COMPACT={env!r}; choose 'tail' or 'off'")

"""Frozen work formulas and the card's peaks: the roofline's yardstick.

Copies of the smoke driver's formulas (``gather_work``, ``kmer_work``,
``gather_pack_work``, ``gather_packed_work``, ``lcp_work``,
``suffix_lcp_work`` and ``bound``): each input byte read once, each output
written once, against the published peaks of one H100 SXM.  They live
here so that a change to the program cannot move the bound it is held to.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory, NVIDIA data sheet
INT32_OPS_PER_S = 67e12     # 32-bit non-tensor peak, NVIDIA data sheet


def bound_ms(nbytes: float, ops: float) -> float:
    """Least milliseconds for the given bytes and 32-bit operations."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3


def gather_work(f: int, nw: int, n_words: int) -> tuple[float, float]:
    """Dense-word gather: offsets, text words touched, output rows."""
    return (f * 4 + min(n_words, f * (nw + 1)) * 4 + f * nw * 4,
            f * nw * 20)


def gather_pack_work(f: int, nw: int, n_s: int) -> tuple[float, float]:
    """Byte-key gather on the byte string: the text read at most once."""
    return f * 4 + min(n_s, f * (4 * nw + 4)) + f * nw * 4, f * nw * 12


def gather_packed_work(f: int, nw: int, bits: int,
                       n_words: int) -> tuple[float, float]:
    """Byte keys read from dense text: each dense word spreads to keys."""
    dense = -(-4 * nw * bits // 32) + 1
    return f * 4 + min(n_words, f * dense) * 4 + f * nw * 4, f * nw * 24


def kmer_work(n: int, k: int, base: int) -> tuple[float, float]:
    """k-mer histogram: the string once, the bins written once."""
    return n + k - 1 + base**k * 4, n * (2 * k + 2)


def lcp_work(f: int, nw: int) -> tuple[float, float]:
    """Key-row LCP: both rows, three outputs, every word compared."""
    return 2 * f * nw * 4 + 3 * f * 4, f * nw * 4 + f * 8


def suffix_lcp_work(pairs: int, reads: int, text_bytes: int,
                    read_bytes: int) -> tuple[float, float]:
    """Suffix-pair LCP on this run's data: both positions in, one LCP
    out, and per suffix the ``reads`` up to its first difference
    (``reads`` summed over the pairs, of ``read_bytes`` each)."""
    return pairs * 12 + min(text_bytes, 2 * reads * read_bytes), reads * 2 * 16

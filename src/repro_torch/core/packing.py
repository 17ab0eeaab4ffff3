"""Byte sort keys, dense k-bit text storage and the word comparison
currency (PyTorch port of ``repro.core.packing``).

**Byte keys** — one byte per symbol code, packed big-endian four symbols
per 32-bit word (:func:`pack_words`, :func:`gather_pack`), so the
UNSIGNED order of the words is the lexicographic order of the symbols.
They are the comparison currency of every byte-per-symbol text (protein,
english, byte, or any alphabet under ``packing="bytes"``) and of the
terminal-bearing probe over dense text (:func:`gather_pack_dense`).  Byte
codes up to 255 reach bit 31 (hazard C5 of the ROADMAP): keys are packed
in int64 and wrapped to int32 bit patterns, and every sort or compare on
them runs unsigned (:func:`to_u64`, :func:`flip_sign`).

**Dense words** — the string is
held DENSE at ``Alphabet.dense_bits`` bits per symbol, big-endian inside
32-bit words, so the bit pattern of a word run IS the lexicographic order
of the symbols it covers.  The terminal is virtual: it only ever occurs at
the end of the string, so every read substitutes :func:`sub_code` for the
positions ``>= n_real`` and carries a per-row limit (the symbol index of
the first terminal).  The comparison rules that keep bits-saturated DNA
exact are those of the JAX module's docstring:

* first difference (XOR + count-leading-zeros) below both limits → a real
  symbol difference;
* otherwise the side whose limit comes first holds ``$`` there and is
  larger, and the LCP is the smaller limit;
* the elastic-range sort appends ``w - limit`` as the least significant
  key (:func:`word_sort_keys`).

Word representation (hazard C1 of the ROADMAP): ``torch.uint32`` has no
shifts, no ``<`` and no ``where``, so words travel as **int32 tensors that
hold the uint32 bit patterns** — the layout the CUDA kernels read as
``uint32_t`` — and the plain code computes in int64 with ``& 0xFFFFFFFF``
(:func:`to_u64` / :func:`to_i32`).  Index tensors stay int32, as in the
JAX package, so positions limit ``n`` to ``< 2**31``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


def to_u64(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns → int64 holding the unsigned 32-bit values."""
    return words.to(torch.int64) & MASK32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 unsigned 32-bit values → int32 tensors of the same bit patterns."""
    return (((x & MASK32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """Word tensor (int32 bit patterns) → numpy uint32, the JAX dtype."""
    return words.detach().cpu().numpy().view(np.uint32)


def flip_sign(words: torch.Tensor) -> torch.Tensor:
    """XOR the sign bit of int32 words: the signed order of the result is
    the unsigned order of the input (``repro.core.packing.flip_sign``)."""
    return words ^ torch.iinfo(torch.int32).min


PACK_SHIFTS = (24, 16, 8, 0)  # big-endian byte positions inside a key word


def pack_words(sym: torch.Tensor) -> torch.Tensor:
    """(…, w) symbol codes → (…, w//4) int32 big-endian byte keys.

    Packed in int64 and wrapped to int32 bit patterns, so codes >= 128
    (the byte alphabet) set bit 31 instead of overflowing."""
    *lead, w = sym.shape
    if w % 4:
        raise ValueError(f"pack width must be a multiple of 4, got {w}")
    grp = sym.to(torch.int64).reshape(*lead, w // 4, 4)
    out = grp[..., 0] << PACK_SHIFTS[0]
    for k in range(1, 4):
        out = out | (grp[..., k] << PACK_SHIFTS[k])
    return to_i32(out)


def gather_pack(s_padded: torch.Tensor, offs: torch.Tensor,
                w: int) -> torch.Tensor:
    """(F, w//4) int32 byte keys of the ``w`` symbols at each offset of a
    terminal-padded byte string — the plain version of the
    ``range_gather_pack`` kernel.  Every symbol index is clamped to
    ``len(s_padded) - 1``, exactly as the JAX ``gather_pack`` clamps."""
    if w % 4:
        raise ValueError(f"pack width must be a multiple of 4, got {w}")
    last = s_padded.shape[0] - 1
    base = (offs.to(torch.int64)[:, None]
            + 4 * torch.arange(w // 4, device=offs.device)[None, :])
    out = None
    for k in range(4):  # one byte lane at a time keeps temporaries (F, w/4)
        byte = s_padded[torch.clamp(base + k, max=last)].to(torch.int64)
        byte = byte << PACK_SHIFTS[k]
        out = byte if out is None else out | byte
    return to_i32(out)


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Count leading zeros of 32-bit words (int32 bit patterns or int64
    unsigned values) by a five-step binary search; clz(0) == 32."""
    u = x.to(torch.int64) & MASK32
    zero = u == 0
    n = torch.zeros_like(u)
    for s, lim in ((16, 0xFFFF), (8, 0xFFFFFF), (4, 0xFFFFFFF),
                   (2, 0x3FFFFFFF), (1, 0x7FFFFFFF)):
        small = u <= lim
        n = n + small.to(torch.int64) * s
        u = torch.where(small, (u << s) & MASK32, u)
    return torch.where(zero, 32, n)


@dataclasses.dataclass(frozen=True)
class PackedText:
    """The string stored dense at ``bits`` bits/symbol in 32-bit words.

    ``words[k]`` holds symbols ``k*spw .. k*spw + spw - 1`` big-endian
    (``spw = 32 // bits``) as int32 bit patterns.  Only the ``n_real`` REAL
    symbols are stored; readers substitute for every position
    ``>= n_real``.  ``words`` carries enough zero tail for the reads a
    caller is contracted to make (``n_real + extra`` symbols, see
    :func:`pack_text`) plus one halo word for shift alignment.
    """

    words: torch.Tensor  # int32[n_words]; uint32 bit patterns
    n_real: int          # symbols stored before the (virtual) terminal
    bits: int            # 2 | 4 | 8
    terminal: int        # the virtual terminal code

    @property
    def syms_per_word(self) -> int:
        return 32 // self.bits

    @property
    def nbytes(self) -> int:
        return int(self.words.shape[0]) * 4

    @property
    def device(self) -> torch.device:
        return self.words.device

    @classmethod
    def from_numpy(cls, words_u32: np.ndarray, n_real: int, bits: int,
                   terminal: int, device="cuda") -> "PackedText":
        """Wrap uint32 words (e.g. the JAX package's ``PackedText.words``
        or an archive's ``s_words``) without changing a bit."""
        w = np.ascontiguousarray(np.asarray(words_u32, np.uint32)).view(np.int32)
        return cls(words=torch.from_numpy(w.copy()).to(device),
                   n_real=int(n_real), bits=int(bits), terminal=int(terminal))

    def words_numpy(self) -> np.ndarray:
        return words_to_numpy(self.words)


def resolve_dense(mode: str, alphabet) -> bool:
    """Does packing ``mode`` select dense storage for ``alphabet``?"""
    if mode == "bytes":
        return False
    if mode == "dense":
        return True
    if mode == "auto":
        return alphabet.dense_bits < 8
    raise ValueError(f"unknown packing mode {mode!r}; "
                     "choose 'auto', 'dense' or 'bytes'")


def dense_range_error(bits: int, alphabet: str, max_code: int) -> ValueError:
    """The error of a code string that does not fit ``bits`` bits a symbol."""
    return ValueError(f"codes exceed {bits}-bit dense range for alphabet "
                      f"{alphabet!r} (max code {max_code})")


def pack_text(codes: np.ndarray, alphabet, *, extra: int = 8,
              device="cuda") -> PackedText:
    """Dense-pack a TERMINATED code string for device-resident reads.

    ``codes``: uint8 codes whose last element is the terminal.  ``extra``:
    how many symbols past the end reads may cover — the word tail is sized
    to ``n_real + extra`` symbols plus one halo word for sub-word shift
    alignment (the same contract as the JAX ``pack_text``).  The ``n_real``
    real codes are copied to ``device`` once and packed there
    (:func:`repro_torch.kernels.pack_text.pack_text_dense`: the kernel on a
    CUDA device, its plain version on the CPU); the copy is dropped once
    the words are made.
    """
    # imported here: the kernels package imports this module
    from repro_torch.kernels.pack_text import pack_text_dense

    codes = np.asarray(codes, np.uint8)
    if codes.size == 0 or codes[-1] != alphabet.terminal_code:
        raise ValueError("pack_text needs a terminated code string")
    bits = alphabet.dense_bits
    n_real = codes.size - 1
    n_words = -(-(n_real + extra) // (32 // bits)) + 1  # +1 halo word
    real = torch.from_numpy(np.ascontiguousarray(codes[:n_real])).to(device)
    words = pack_text_dense(real, n_words, bits, alphabet.name)
    return PackedText(words=words, n_real=n_real, bits=bits,
                      terminal=alphabet.terminal_code)


def pack_text_stream(chunks, alphabet, *, extra: int = 8,
                     device="cuda") -> PackedText:
    """Dense-pack a terminated code string delivered in CHUNKS (the JAX
    ``pack_text_stream``).

    ``chunks`` is any iterable of uint8 code arrays whose concatenation is
    a terminated code string (the :func:`pack_text` input contract), of
    any sizes, consumed one at a time: the host holds one chunk plus a
    carry of fewer than ``syms_per_word`` symbols.  Equal to
    :func:`pack_text` on the concatenation: symbols are committed to
    words only on ``syms_per_word`` boundaries, the last symbol of the
    stream is held back one step (it must be the terminal, which is
    virtual and never stored), and the zero tail follows the same
    ``n_real + extra`` formula.  The words move to ``device`` once.
    """
    bits = alphabet.dense_bits
    spw = 32 // bits
    shifts = (32 - bits * (np.arange(spw, dtype=np.uint32) + 1))
    word_parts: list[np.ndarray] = []
    carry = np.zeros(0, np.uint32)   # committed symbols short of a word
    pending = None                   # last symbol seen; terminal candidate
    n_real = 0

    def commit(sym: np.ndarray) -> None:
        nonlocal carry
        buf = np.concatenate([carry, sym]) if carry.size else sym
        n_full = buf.size // spw
        if n_full:
            head = buf[:n_full * spw].reshape(n_full, spw)
            word_parts.append(
                (head << shifts[None, :]).sum(axis=1, dtype=np.uint32))
        carry = buf[n_full * spw:]

    for chunk in chunks:
        c = np.asarray(chunk, np.uint8).astype(np.uint32)
        if c.size == 0:
            continue
        if pending is not None:
            c = np.concatenate([np.array([pending], np.uint32), c])
        pending = int(c[-1])
        real = c[:-1]
        if real.size and int(real.max()) >= (1 << bits):
            raise dense_range_error(bits, alphabet.name, int(real.max()))
        n_real += real.size
        commit(real)
    if pending is None or pending != alphabet.terminal_code:
        raise ValueError("pack_text_stream needs a terminated code string")

    n_words = -(-(n_real + extra) // spw) + 1  # same formula as pack_text
    commit(np.zeros(n_words * spw - n_real, np.uint32))
    assert carry.size == 0
    words = (np.concatenate(word_parts) if word_parts
             else np.zeros(0, np.uint32))
    return PackedText.from_numpy(words, n_real, bits, alphabet.terminal_code,
                                 device)


def unpack_text(pt: PackedText, n: int | None = None) -> np.ndarray:
    """Decode dense storage back to uint8 codes (terminal included)."""
    n_real = pt.n_real
    n = n_real + 1 if n is None else int(n)
    spw = pt.syms_per_word
    words = pt.words_numpy()
    shifts = (32 - pt.bits * (np.arange(spw, dtype=np.uint32) + 1))
    sym = ((words[:, None] >> shifts[None, :]) & ((1 << pt.bits) - 1))
    sym = sym.reshape(-1)[:n].astype(np.uint8)
    sym[n_real:] = pt.terminal
    return sym


def gather_symbols_dense(pt: PackedText, offs: torch.Tensor,
                         w: int) -> torch.Tensor:
    """(F, w) int32 symbol codes at each offset from dense storage, with
    the terminal itself for positions ``>= n_real`` — what a ``take``
    from the terminal-padded byte string returns."""
    bits, spw = pt.bits, pt.syms_per_word
    aligned = _aligned_words(pt, offs, w)                       # (F, nw)
    shifts = 32 - bits * (torch.arange(spw, device=offs.device) + 1)
    sym = (aligned[:, :, None] >> shifts) & ((1 << bits) - 1)
    sym = sym.reshape(offs.shape[0], -1)[:, :w]
    past_end = (offs.to(torch.int64)[:, None]
                + torch.arange(w, device=offs.device)[None, :] >= pt.n_real)
    return torch.where(past_end, pt.terminal, sym).to(torch.int32)


def _spread_to_bytes(chunk: torch.Tensor, bits: int) -> torch.Tensor:
    """Spread 4 right-aligned ``bits``-bit fields of a 32-bit lane (int64
    unsigned values) into the lane's 4 big-endian bytes."""
    if bits == 8:
        return chunk
    if bits == 4:
        t = (chunk | (chunk << 8)) & 0x00FF00FF
        return (t | (t << 4)) & 0x0F0F0F0F
    if bits == 2:
        t = (chunk | (chunk << 12)) & 0x000F000F
        return (t | (t << 6)) & 0x03030303
    raise ValueError(f"unsupported dense bits {bits}")


_KEEP_BYTES = (0, 0xFF000000, 0xFFFF0000, 0xFFFFFF00, 0xFFFFFFFF)


def gather_pack_dense(pt: PackedText, offs: torch.Tensor,
                      w: int) -> torch.Tensor:
    """(F, w//4) int32 byte keys read from dense storage, bit-identical to
    :func:`gather_pack` on the terminal-padded byte string: each output
    word is one ``4*bits``-bit chunk of the aligned dense words spread to
    bytes, with terminal bytes patched in past ``n_real``."""
    bits, spw = pt.bits, pt.syms_per_word
    if w % 4:
        raise ValueError(f"pack width must be a multiple of 4, got {w}")
    f = offs.shape[0]
    n_out = w // 4
    aligned = _aligned_words(pt, offs, w)  # (F, ceil(w/spw)) int64
    cpw = spw // 4  # output words per dense word
    if cpw > 1:
        csh = 32 - (4 * bits) * (torch.arange(cpw, device=offs.device) + 1)
        chunks = (aligned[:, :, None] >> csh) & ((1 << (4 * bits)) - 1)
        chunks = chunks.reshape(f, aligned.shape[1] * cpw)[:, :n_out]
    else:
        chunks = aligned[:, :n_out]
    out = _spread_to_bytes(chunks, bits)
    t_word = (pt.terminal & 0xFF) * 0x01010101
    keep_tab = torch.tensor(_KEEP_BYTES, dtype=torch.int64, device=offs.device)
    v = torch.clamp(pt.n_real - (offs.to(torch.int64)[:, None] + 4 * torch.arange(
        n_out, device=offs.device)[None, :]), 0, 4)
    keep = keep_tab[v]
    return to_i32((out & keep) | (t_word & ~keep & MASK32))


def syms_per_word(bits: int) -> int:
    return 32 // bits


def sub_code(bits: int, terminal: int) -> int:
    """The code substituted for the virtual terminal in dense word reads:
    the largest representable code (the terminal itself when it fits)."""
    return min(terminal, (1 << bits) - 1)


def _sub_word(bits: int, terminal: int) -> int:
    """``sub_code`` replicated across every field of a 32-bit word."""
    sub = sub_code(bits, terminal)
    return sum(sub << (bits * k) for k in range(syms_per_word(bits)))


def pack_dense(sym: torch.Tensor, bits: int) -> torch.Tensor:
    """(…, m) symbol codes (< 2**bits) → (…, ceil(m/spw)) int32 dense
    big-endian words, zero-padded past ``m`` (the pattern-side packing)."""
    *lead, m = sym.shape
    spw = syms_per_word(bits)
    m_pad = -(-m // spw) * spw
    sym = sym.to(torch.int64)
    if m_pad != m:
        pad = torch.zeros((*lead, m_pad - m), dtype=torch.int64,
                          device=sym.device)
        sym = torch.cat([sym, pad], dim=-1)
    grp = sym.reshape(*lead, m_pad // spw, spw)
    shifts = 32 - bits * (torch.arange(spw, device=sym.device) + 1)
    return to_i32((grp << shifts).sum(dim=-1))


def pack_pattern_dense(sym: torch.Tensor, bits: int,
                       terminal: int) -> torch.Tensor:
    """Pack a (…, m) pattern batch to dense words, substituting the
    terminal code (``minimum`` with :func:`sub_code`)."""
    return pack_dense(torch.clamp(sym.to(torch.int64),
                                  max=sub_code(bits, terminal)), bits)


def _aligned_words(pt: PackedText, offs: torch.Tensor, w: int) -> torch.Tensor:
    """(F, ceil(w/spw)) unsigned words (int64), shift-aligned to each offset."""
    bits, spw = pt.bits, pt.syms_per_word
    nw = -(-w // spw)
    offs = offs.to(torch.int64)
    word0 = offs // spw
    idx = word0[:, None] + torch.arange(nw + 1, device=offs.device)[None, :]
    idx = torch.clamp(idx, max=pt.words.shape[0] - 1)  # safety net, as in JAX
    words = to_u64(pt.words[idx])                               # (F, nw+1)
    sh = (bits * (offs % spw))[:, None]
    hi = (words[:, :-1] << sh) & MASK32
    lo = (words[:, 1:] >> 1) >> (31 - sh)  # == x >> (32 - sh), 0 at sh == 0
    return hi | lo


def gather_words_dense(pt: PackedText, offs: torch.Tensor,
                       w: int) -> torch.Tensor:
    """(F, ceil(w/spw)) int32 dense words, shift-aligned to each offset,
    with :func:`sub_code` substituted for every position ``>= n_real`` —
    the plain version of the ``range_gather_words`` kernel."""
    bits, spw = pt.bits, pt.syms_per_word
    aligned = _aligned_words(pt, offs, w)
    nw = aligned.shape[1]
    starts = (offs.to(torch.int64)[:, None]
              + spw * torch.arange(nw, device=offs.device)[None, :])
    v = torch.clamp(pt.n_real - starts, 0, spw)
    keep = torch.where(
        v > 0, (MASK32 << ((spw - torch.clamp(v, min=1)) * bits)) & MASK32, 0)
    sub_w = _sub_word(bits, pt.terminal)
    return to_i32((aligned & keep) | (sub_w & ~keep & MASK32))


def word_limit(n_real: int, offs: torch.Tensor, w: int) -> torch.Tensor:
    """Symbol index of the first (virtual) terminal in a width-``w`` read
    at each offset, clipped to [0, w] — the per-row comparison limit."""
    return torch.clamp(n_real - offs.to(torch.int64), 0, w).to(torch.int32)


def lcp_words(a: torch.Tensor, b: torch.Tensor, bits: int) -> torch.Tensor:
    """First differing SYMBOL index of (F, NW) dense word rows: XOR, first
    non-zero word, count-leading-zeros.  Equal rows return ``NW * spw``."""
    spw = syms_per_word(bits)
    nw = a.shape[-1]
    x = a ^ b
    neq = x != 0
    iota = torch.arange(nw, device=a.device)
    wi = torch.where(neq, iota, nw).amin(dim=-1)
    any_neq = wi < nw
    xw = torch.take_along_dim(x, torch.clamp(wi, max=nw - 1)[..., None],
                              dim=-1)[..., 0]
    sym = clz32(xw) // bits
    return torch.where(any_neq, wi * spw + sym, nw * spw).to(torch.int32)


def extract_sym(words: torch.Tensor, idx: torch.Tensor,
                bits: int) -> torch.Tensor:
    """The ``bits``-wide field at symbol index ``idx`` of each word row."""
    spw = syms_per_word(bits)
    idx = idx.to(torch.int64)
    wv = torch.take_along_dim(words, (idx // spw)[..., None], dim=-1)[..., 0]
    sh = 32 - bits * (idx % spw + 1)
    return ((to_u64(wv) >> sh) & ((1 << bits) - 1)).to(torch.int32)


def lcp_words_limited(a: torch.Tensor, b: torch.Tensor, lim_a: torch.Tensor,
                      lim_b: torch.Tensor, w: int, bits: int) -> torch.Tensor:
    """Row LCP in symbols, capped at ``w``: ``min(first_diff, lim_a,
    lim_b, w)`` of substituted dense word rows."""
    p = lcp_words(a, b, bits)
    return torch.clamp(torch.minimum(torch.minimum(p, lim_a), lim_b),
                       max=w).to(torch.int32)


def lcp_adjacent_words(prev: torch.Tensor, cur: torch.Tensor,
                       lim_prev: torch.Tensor, lim_cur: torch.Tensor, w: int,
                       bits: int, terminal: int):
    """(lcp, c1, c2) per row of adjacent word rows, with the true terminal
    code restored at a divergence that falls ON a row's limit.
    Fully-equal rows (lcp == w) report c1 == c2 == 0."""
    spw = syms_per_word(bits)
    nw = cur.shape[-1]
    lcp = lcp_words_limited(prev, cur, lim_prev, lim_cur, w, bits)
    idx = torch.clamp(lcp, 0, nw * spw - 1)
    ca = extract_sym(prev, idx, bits)
    cb = extract_sym(cur, idx, bits)
    diverged = lcp < w
    c1 = torch.where(diverged, torch.where(lim_prev == lcp, terminal, ca), 0)
    c2 = torch.where(diverged, torch.where(lim_cur == lcp, terminal, cb), 0)
    return lcp, c1.to(torch.int32), c2.to(torch.int32)


def word_sort_keys(pt: PackedText, offs: torch.Tensor, w: int,
                   gather_words=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(keys, tie) for the elastic-range sort on dense word keys: keys are
    the (F, ceil(w/spw)) substituted words, tie the int32 ``w - limit``
    least significant key (the row whose terminal comes first is larger)."""
    gather = gather_words or gather_words_dense
    keys = gather(pt, offs, w)
    tie = (w - word_limit(pt.n_real, offs, w)).to(torch.int32)
    return keys, tie

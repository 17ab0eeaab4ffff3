"""Wrappers of the word-currency CUDA kernels over the dense text.

* :func:`range_gather_words` — ``csrc/range_gather_words.cu``, the port of
  ``repro/kernels/packed_gather.py:range_gather_words``: ``ceil(w/spw)``
  shift-aligned, terminal-substituted dense words per offset, rows under
  an optional mask zeroed in the kernel.
* :func:`pattern_probe_words` — ``csrc/pattern_probe_words.cu``, the port
  of ``repro/kernels/packed_gather.py:pattern_probe_words``: the −1/0/+1
  verdict of a masked dense pattern against the suffix at each position.
* :func:`pattern_probe_packed` — ``csrc/pattern_probe_packed.cu``, the
  port of ``repro/kernels/packed_gather.py:pattern_probe_packed``: the
  byte-key probe over the dense text (the search step of a batch that
  carries the terminal code).
* :func:`range_gather_packed` — ``csrc/range_gather_packed.cu``, the port
  of ``repro/kernels/packed_gather.py:range_gather_packed``: byte keys read
  from the dense text, equal to ``range_gather_pack`` on the byte string
  (the ``REPRO_WORD_COMPARE=byte`` oracle's construction read), rows under
  an optional mask zeroed in the kernel.
* :func:`suffix_lcp_words` — ``csrc/suffix_lcp_words.cu``, the port of
  ``repro/kernels/packed_gather.py:suffix_lcp_words``: the LCP of suffix
  pairs by XOR + clz on dense words, capped at ``w`` and both terminal
  limits (global-LCP boundaries, ``node_lcp="words"``); it tallies the
  ``rows`` (pairs) and ``words_read`` (text words loaded, an upper bound
  from ``w``) of its launches.

Dispatch goes by the device of the tensors: CUDA tensors launch the kernel
(or raise), CPU tensors run the plain version in :mod:`.ref`.  Each wrapper
counts its launches in its ``launches`` attribute, where it launches and
nowhere else; ``range_gather_words`` and ``range_gather_packed`` also
tally the ``rows`` and ``words`` their launches gathered.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.packing import PackedText, _sub_word
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_U32 = ctypes.c_uint


def _on_cpu(*tensors: torch.Tensor | None) -> bool:
    """True when every tensor (None: an optional one left out) lies on the
    CPU; raise on a device mix or on a device that is neither the CPU nor
    CUDA."""
    tensors = [t for t in tensors if t is not None]
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"tensors must all lie on the CPU or on one CUDA "
                     f"device, got {sorted(str(t.device) for t in tensors)}")


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-D {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")


def _check_probe_rows(pos: torch.Tensor, pat_words: torch.Tensor,
                      mask_words: torch.Tensor) -> None:
    """Shapes and dtypes of a byte-key probe batch on the card."""
    _require(pos, "pos", torch.int32, 1)
    _require(pat_words, "pat_words", torch.int32, 2)
    _require(mask_words, "mask_words", torch.int32, 2)
    if (mask_words.shape != pat_words.shape
            or pos.shape[0] != pat_words.shape[0]):
        raise ValueError("byte-key probe: row counts disagree")


def _check_extra(pt: PackedText, w: int) -> None:
    """The read contract of :func:`repro_torch.core.packing.pack_text`: a
    ``w``-symbol read at any offset up to ``n_real`` stays in the words."""
    spw = pt.syms_per_word
    need = -(-(pt.n_real + w) // spw) + 1
    if pt.words.shape[0] < need:
        raise ValueError(
            f"reads of {w} symbols need {need} words but the text holds "
            f"{pt.words.shape[0]}: pack it with a larger extra")


def _stream(device: torch.device) -> _P:
    return _P(torch.cuda.current_stream(device).cuda_stream)


def _check_mask(mask: torch.Tensor | None, f: int) -> None:
    """A row mask is a contiguous bool vector with one entry per offset."""
    if mask is not None:
        _require(mask, "mask", torch.bool, 1)
        if mask.shape[0] != f:
            raise ValueError(f"mask has {mask.shape[0]} rows, offs {f}")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def range_gather_words(pt: PackedText, offs: torch.Tensor, w: int,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """(F, ceil(w/spw)) int32 dense words (uint32 bit patterns) at each
    offset, bit-identical to :func:`repro_torch.core.packing.gather_words_dense`.

    ``offs``: int32[F] offsets in ``[0, n_real]``.  ``mask``: bool[F] or
    None; a row whose mask is False is all zero words and reads no text
    (``torch.where(mask[:, None], keys, 0)``, fused).
    """
    if _on_cpu(pt.words, offs, mask):
        return _ref.range_gather_words_ref(pt, offs, w, mask)
    _require(pt.words, "words", torch.int32, 1)
    _require(offs, "offs", torch.int32, 1)
    _check_extra(pt, w)
    nw = -(-w // pt.syms_per_word)
    f = offs.shape[0]
    _check_mask(mask, f)
    out = torch.empty((f, nw), dtype=torch.int32, device=offs.device)
    if f == 0:
        return out
    fn = _build.entry("range_gather_words",
              [_P, _I64, _P, _I64, _I32, _I32, _I64, _U32, _P, _P, _P])
    with torch.cuda.device(offs.device):
        rc = fn(pt.words.data_ptr(), pt.words.shape[0], offs.data_ptr(), f,
                nw, pt.bits, pt.n_real, _sub_word(pt.bits, pt.terminal),
                _ptr(mask), out.data_ptr(), _stream(offs.device))
    _build.check(rc, "range_gather_words")
    range_gather_words.launches += 1
    range_gather_words.rows += f
    range_gather_words.words += f * nw
    return out


range_gather_words.launches = 0
range_gather_words.rows = 0
range_gather_words.words = 0


def pattern_probe_words(pt: PackedText, pos: torch.Tensor,
                        pat_dense: torch.Tensor, mask_dense: torch.Tensor,
                        lengths: torch.Tensor,
                        lim_p: torch.Tensor | None = None) -> torch.Tensor:
    """int32[B] in {−1, 0, +1}: each masked dense pattern row against the
    suffix at ``pos``, bit-identical to
    :func:`repro_torch.kernels.ref.pattern_probe_words_ref`.

    pat_dense / mask_dense: (B, NW) int32 dense rows; lengths: int32[B]
    compare lengths; lim_p: the pattern side's first-terminal index
    (defaults to ``lengths``: no terminal in the pattern).
    """
    if lim_p is None:
        lim_p = lengths
    if _on_cpu(pt.words, pos, pat_dense, mask_dense, lengths, lim_p):
        return _ref.pattern_probe_words_ref(pt, pos, pat_dense, mask_dense,
                                            lengths, lim_p)
    b, nw = pat_dense.shape
    _require(pt.words, "words", torch.int32, 1)
    _require(pos, "pos", torch.int32, 1)
    _require(pat_dense, "pat_dense", torch.int32, 2)
    _require(mask_dense, "mask_dense", torch.int32, 2)
    _require(lengths, "lengths", torch.int32, 1)
    _require(lim_p, "lim_p", torch.int32, 1)
    if (mask_dense.shape != (b, nw) or pos.shape[0] != b
            or lengths.shape[0] != b or lim_p.shape[0] != b):
        raise ValueError("pattern_probe_words: row counts disagree")
    _check_extra(pt, nw * pt.syms_per_word)
    out = torch.empty(b, dtype=torch.int32, device=pos.device)
    if b == 0:
        return out
    fn = _build.entry("pattern_probe_words",
              [_P, _I64, _P, _P, _P, _P, _P, _I64, _I32, _I32, _I64, _U32,
               _P, _P])
    with torch.cuda.device(pos.device):
        rc = fn(pt.words.data_ptr(), pt.words.shape[0], pos.data_ptr(),
                pat_dense.data_ptr(), mask_dense.data_ptr(),
                lengths.data_ptr(), lim_p.data_ptr(), b, nw, pt.bits,
                pt.n_real, _sub_word(pt.bits, pt.terminal), out.data_ptr(),
                _stream(pos.device))
    _build.check(rc, "pattern_probe_words")
    pattern_probe_words.launches += 1
    return out


pattern_probe_words.launches = 0


def pattern_probe_packed(pt: PackedText, pos: torch.Tensor,
                         pat_words: torch.Tensor,
                         mask_words: torch.Tensor) -> torch.Tensor:
    """int32[B] in {−1, 0, +1}: the byte-key probe of
    :func:`repro_torch.kernels.pattern_probe.pattern_probe` reading the
    dense text, bit-identical to
    :func:`repro_torch.kernels.ref.pattern_probe_packed_ref` (and so to the
    byte probe on the terminal-padded string).

    pat_words / mask_words: (B, W) int32 byte-packed pattern rows and
    0xFF-byte masks, zero past each pattern length.
    """
    if _on_cpu(pt.words, pos, pat_words, mask_words):
        return _ref.pattern_probe_packed_ref(pt, pos, pat_words, mask_words)
    _require(pt.words, "words", torch.int32, 1)
    _check_probe_rows(pos, pat_words, mask_words)
    b, nw = pat_words.shape
    _check_extra(pt, nw * 4)
    out = torch.empty(b, dtype=torch.int32, device=pos.device)
    if b == 0:
        return out
    fn = _build.entry("pattern_probe_packed",
                      [_P, _I64, _P, _P, _P, _I64, _I32, _I32, _I64, _U32,
                       _P, _P])
    with torch.cuda.device(pos.device):
        rc = fn(pt.words.data_ptr(), pt.words.shape[0], pos.data_ptr(),
                pat_words.data_ptr(), mask_words.data_ptr(), b, nw, pt.bits,
                pt.n_real, (pt.terminal & 0xFF) * 0x01010101, out.data_ptr(),
                _stream(pos.device))
    _build.check(rc, "pattern_probe_packed")
    pattern_probe_packed.launches += 1
    return out


pattern_probe_packed.launches = 0


def range_gather_packed(pt: PackedText, offs: torch.Tensor, w: int,
                        mask: torch.Tensor | None = None) -> torch.Tensor:
    """(F, w//4) int32 big-endian byte keys of the ``w`` symbols at each
    offset, read from the dense text — bit-identical to
    :func:`repro_torch.core.packing.gather_pack_dense` (and so to
    ``range_gather_pack`` on the terminal-padded byte string).

    ``offs``: int32[F] offsets ``>= 0``; past ``n_real`` every symbol is
    the terminal.  ``mask``: bool[F] or None; a row whose mask is False is
    all zero words and reads no text.
    """
    if w % 4:
        raise ValueError(f"pack width must be a multiple of 4, got {w}")
    if _on_cpu(pt.words, offs, mask):
        return _ref.range_gather_packed_ref(pt, offs, w, mask)
    _require(pt.words, "words", torch.int32, 1)
    _require(offs, "offs", torch.int32, 1)
    _check_extra(pt, w)
    nw = w // 4
    f = offs.shape[0]
    _check_mask(mask, f)
    out = torch.empty((f, nw), dtype=torch.int32, device=offs.device)
    if f == 0:
        return out
    fn = _build.entry("range_gather_packed",
                      [_P, _I64, _P, _I64, _I32, _I32, _I64, _U32, _P, _P,
                       _P])
    with torch.cuda.device(offs.device):
        rc = fn(pt.words.data_ptr(), pt.words.shape[0], offs.data_ptr(), f,
                nw, pt.bits, pt.n_real, (pt.terminal & 0xFF) * 0x01010101,
                _ptr(mask), out.data_ptr(), _stream(offs.device))
    _build.check(rc, "range_gather_packed")
    range_gather_packed.launches += 1
    range_gather_packed.rows += f
    range_gather_packed.words += f * nw
    return out


range_gather_packed.launches = 0
range_gather_packed.rows = 0
range_gather_packed.words = 0


def suffix_lcp_words(pt: PackedText, pos_a: torch.Tensor, pos_b: torch.Tensor,
                     w: int) -> torch.Tensor:
    """int32[B] LCP in symbols of the suffixes at ``pos_a`` and ``pos_b``
    of the dense text, capped at ``w`` and at both terminal limits —
    bit-identical to :func:`repro_torch.kernels.ref.suffix_lcp_words_ref`.
    """
    if pos_a.shape != pos_b.shape or pos_a.dim() != 1:
        raise ValueError(f"suffix_lcp_words needs two equal 1-D position "
                         f"arrays, got {tuple(pos_a.shape)} and "
                         f"{tuple(pos_b.shape)}")
    if _on_cpu(pt.words, pos_a, pos_b):
        return _ref.suffix_lcp_words_ref(pt, pos_a, pos_b, w)
    _require(pt.words, "words", torch.int32, 1)
    _require(pos_a, "pos_a", torch.int32, 1)
    _require(pos_b, "pos_b", torch.int32, 1)
    _check_extra(pt, w)
    nw = -(-w // pt.syms_per_word)
    b = pos_a.shape[0]
    out = torch.empty(b, dtype=torch.int32, device=pos_a.device)
    if b == 0:
        return out
    fn = _build.entry("suffix_lcp_words",
                      [_P, _I64, _P, _P, _I64, _I32, _I32, _I32, _I64, _P,
                       _P])
    with torch.cuda.device(pos_a.device):
        rc = fn(pt.words.data_ptr(), pt.words.shape[0], pos_a.data_ptr(),
                pos_b.data_ptr(), b, nw, w, pt.bits, pt.n_real,
                out.data_ptr(), _stream(pos_a.device))
    _build.check(rc, "suffix_lcp_words")
    suffix_lcp_words.launches += 1
    suffix_lcp_words.rows += b
    suffix_lcp_words.words_read += 2 * b * lcp_words_loaded(nw)
    return out


def lcp_words_loaded(nw: int) -> int:
    """Text words the ``suffix_lcp_words`` kernel loads for one suffix of
    a pair at most: the aligned 16-byte pair of loads (8 words) for each
    chunk of 4 words, or the ``nw + 1`` words of a narrower read."""
    return 8 * -(-nw // 4) if nw >= 4 else nw + 1


suffix_lcp_words.launches = 0
suffix_lcp_words.rows = 0
suffix_lcp_words.words_read = 0

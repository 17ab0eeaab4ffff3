"""Wrappers of the fused find-and-fetch CUDA kernels over the dense text.

* :func:`probe_gather_words` — ``csrc/probe_gather_words.cu``, the port of
  ``repro/kernels/probe_gather.py:probe_gather_words``: the
  ``pattern_probe_words`` verdict plus the ``range_gather_words`` window at
  the same positions, from one read.
* :func:`probe_gather_packed` — ``csrc/probe_gather_packed.cu``, the port
  of ``repro/kernels/probe_gather.py:probe_gather_packed``: the
  ``pattern_probe_packed`` verdict plus the ``range_gather_packed`` byte-key
  window at the same positions.

Both equal the two-launch composition of their currency's probe and
gather, which is what their plain versions in :mod:`.ref` are.  Dispatch
goes by the device of the tensors (CUDA: the kernel or raise; CPU: the
plain version); launches are counted in each wrapper's ``launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.packing import PackedText, _sub_word
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.packed_gather import (
    _check_extra,
    _check_probe_rows,
    _on_cpu,
    _require,
    _stream,
    _t_word,
)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_U32 = ctypes.c_uint


def probe_gather_words(pt: PackedText, pos: torch.Tensor,
                       pat_dense: torch.Tensor, mask_dense: torch.Tensor,
                       lengths: torch.Tensor, fetch: int,
                       lim_p: torch.Tensor | None = None):
    """``(cmp int32[B], win int32[B, ceil(fetch/spw)])``: the verdict of
    :func:`repro_torch.kernels.packed_gather.pattern_probe_words` and the
    ``fetch``-symbol dense window of ``range_gather_words`` at ``pos``,
    bit-identical to :func:`repro_torch.kernels.ref.probe_gather_words_ref`.
    """
    if lim_p is None:
        lim_p = lengths
    if _on_cpu(pt.words, pos, pat_dense, mask_dense, lengths, lim_p):
        return _ref.probe_gather_words_ref(pt, pos, pat_dense, mask_dense,
                                           lengths, lim_p, fetch=fetch)
    b, nw_pat = pat_dense.shape
    _require(pt.words, "words", torch.int32, 1)
    _require(pos, "pos", torch.int32, 1)
    _require(pat_dense, "pat_dense", torch.int32, 2)
    _require(mask_dense, "mask_dense", torch.int32, 2)
    _require(lengths, "lengths", torch.int32, 1)
    _require(lim_p, "lim_p", torch.int32, 1)
    if (mask_dense.shape != (b, nw_pat) or pos.shape[0] != b
            or lengths.shape[0] != b or lim_p.shape[0] != b):
        raise ValueError("probe_gather_words: row counts disagree")
    spw = pt.syms_per_word
    nw_out = -(-fetch // spw)
    _check_extra(pt, max(nw_pat * spw, fetch))
    cmp = torch.empty(b, dtype=torch.int32, device=pos.device)
    win = torch.empty((b, nw_out), dtype=torch.int32, device=pos.device)
    if b == 0:
        return cmp, win
    fn = _build.entry("probe_gather_words",
                      [_P, _I64, _P, _P, _P, _P, _P, _I64, _I32, _I32, _I32,
                       _I64, _U32, _P, _P, _P])
    with torch.cuda.device(pos.device):
        rc = fn(pt.words.data_ptr(), pt.words.shape[0], pos.data_ptr(),
                pat_dense.data_ptr(), mask_dense.data_ptr(),
                lengths.data_ptr(), lim_p.data_ptr(), b, nw_pat, nw_out,
                pt.bits, pt.n_real, _sub_word(pt.bits, pt.terminal),
                cmp.data_ptr(), win.data_ptr(), _stream(pos.device))
    _build.check(rc, "probe_gather_words")
    probe_gather_words.launches += 1
    return cmp, win


probe_gather_words.launches = 0


def probe_gather_packed(pt: PackedText, pos: torch.Tensor,
                        pat_words: torch.Tensor, mask_words: torch.Tensor,
                        fetch: int):
    """``(cmp int32[B], keys int32[B, fetch//4])``: the verdict of
    :func:`repro_torch.kernels.packed_gather.pattern_probe_packed` and the
    byte-key window of ``range_gather_packed`` at ``pos``, bit-identical to
    :func:`repro_torch.kernels.ref.probe_gather_packed_ref`."""
    if fetch % 4:
        raise ValueError(f"fetch must be a multiple of 4, got {fetch}")
    if _on_cpu(pt.words, pos, pat_words, mask_words):
        return _ref.probe_gather_packed_ref(pt, pos, pat_words, mask_words,
                                            fetch=fetch)
    _require(pt.words, "words", torch.int32, 1)
    _check_probe_rows(pos, pat_words, mask_words)
    b, nw_pat = pat_words.shape
    nw_out = fetch // 4
    _check_extra(pt, 4 * max(nw_pat, nw_out))
    cmp = torch.empty(b, dtype=torch.int32, device=pos.device)
    keys = torch.empty((b, nw_out), dtype=torch.int32, device=pos.device)
    if b == 0:
        return cmp, keys
    fn = _build.entry("probe_gather_packed",
                      [_P, _I64, _P, _P, _P, _I64, _I32, _I32, _I32, _I64,
                       _U32, _P, _P, _P])
    with torch.cuda.device(pos.device):
        rc = fn(pt.words.data_ptr(), pt.words.shape[0], pos.data_ptr(),
                pat_words.data_ptr(), mask_words.data_ptr(), b, nw_pat,
                nw_out, pt.bits, pt.n_real, _t_word(pt), cmp.data_ptr(),
                keys.data_ptr(), _stream(pos.device))
    _build.check(rc, "probe_gather_packed")
    probe_gather_packed.launches += 1
    return cmp, keys


probe_gather_packed.launches = 0

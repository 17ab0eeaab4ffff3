"""Wrapper of the suffix-pair LCP CUDA kernel on byte text (global LCP).

:func:`suffix_lcp_pairs` runs ``csrc/suffix_lcp_pairs.cu``, the port of
``repro/kernels/suffix_lcp.py:suffix_lcp_pairs``, for CUDA tensors and the
plain version (:func:`repro_torch.kernels.ref.suffix_lcp_pairs_ref`) for
CPU tensors.  Launches are counted in ``suffix_lcp_pairs.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.packed_gather import _on_cpu, _require, _stream
from repro_torch.kernels.range_gather import require_byte_text

_P = ctypes.c_void_p


def suffix_lcp_pairs(s_padded: torch.Tensor, pos_a: torch.Tensor,
                     pos_b: torch.Tensor, w: int) -> torch.Tensor:
    """int32[B]: the first unequal symbol index of the suffixes at
    ``pos_a`` and ``pos_b`` of a byte-per-symbol string within ``w``
    symbols, or ``w`` — every symbol index clamped to
    ``len(s_padded) - 1``, as :func:`repro_torch.core.packing.gather_pack`
    clamps.  ``w`` must be a multiple of 4."""
    if w % 4 or w < 4:
        raise ValueError(f"suffix_lcp_pairs needs w a positive multiple of "
                         f"4, got {w}")
    if pos_a.shape != pos_b.shape or pos_a.dim() != 1:
        raise ValueError(f"suffix_lcp_pairs needs two equal 1-D position "
                         f"arrays, got {tuple(pos_a.shape)} and "
                         f"{tuple(pos_b.shape)}")
    if _on_cpu(s_padded, pos_a, pos_b):
        return _ref.suffix_lcp_pairs_ref(s_padded, pos_a, pos_b, w)
    require_byte_text(s_padded)
    _require(pos_a, "pos_a", torch.int32, 1)
    _require(pos_b, "pos_b", torch.int32, 1)
    b = pos_a.shape[0]
    out = torch.empty(b, dtype=torch.int32, device=pos_a.device)
    if b == 0:
        return out
    fn = _build.entry("suffix_lcp_pairs",
                      [_P, ctypes.c_longlong, _P, _P, ctypes.c_longlong,
                       ctypes.c_int, _P, _P])
    with torch.cuda.device(pos_a.device):
        rc = fn(s_padded.data_ptr(), s_padded.shape[0], pos_a.data_ptr(),
                pos_b.data_ptr(), b, w, out.data_ptr(), _stream(pos_a.device))
    _build.check(rc, "suffix_lcp_pairs")
    suffix_lcp_pairs.launches += 1
    return out


suffix_lcp_pairs.launches = 0

"""Wrapper of the adjacent-row LCP CUDA kernel (SubTreePrepare branching).

:func:`lcp_pairs` runs ``csrc/lcp_pairs.cu``, the port of
``repro/kernels/lcp.py:lcp_pairs``, for CUDA tensors and the plain version
(:func:`repro_torch.kernels.ref.lcp_pairs_ref`) for CPU tensors.
Launches are counted in ``lcp_pairs.launches``.  Fake tensors,
DTensors and dispatch modes reach the launch through the custom op
``repro_torch::lcp_pairs`` (one (3, F) output), whose fake
implementation gives its shape and launches nothing (the dry run);
:func:`repro_torch.kernels.packed_gather.register_sharding_rules` gives
DTensor its row sharding.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.packed_gather import (
    _direct,
    _on_cpu,
    _require,
    _stream,
)

_P = ctypes.c_void_p


def lcp_pairs(a: torch.Tensor, b: torch.Tensor, w: int):
    """(lcp, c1, c2) int32[F] of (F, W) int32 byte-key rows: the first
    differing symbol index capped at ``w`` and that symbol of each row;
    fully equal rows give ``lcp == w`` and ``c1 == c2 == 0``."""
    f, nw = a.shape
    if b.shape != (f, nw) or nw * 4 < w:
        raise ValueError(f"lcp_pairs needs two (F, W >= w/4) rows, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)} at w={w}")
    _on_cpu(a, b)
    if _direct(a, b):
        out = _lcp_pairs_impl(a, b, w)
    else:
        out = torch.ops.repro_torch.lcp_pairs(a, b, w)
    return out[0], out[1], out[2]


lcp_pairs.launches = 0


def _lcp_pairs_impl(a: torch.Tensor, b: torch.Tensor, w: int) -> torch.Tensor:
    """(3, F) int32 rows (lcp, c1, c2): the kernel launch on CUDA tensors,
    the plain version on CPU ones."""
    if _on_cpu(a, b):
        return torch.stack(_ref.lcp_pairs_ref(a, b, w))
    _require(a, "a", torch.int32, 2)
    _require(b, "b", torch.int32, 2)
    f, nw = a.shape
    out = torch.empty((3, f), dtype=torch.int32, device=a.device)
    if f == 0:
        return out
    fn = _build.entry("lcp_pairs", [_P, _P, ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_int, _P, _P, _P, _P])
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), b.data_ptr(), f, nw, w, out[0].data_ptr(),
                out[1].data_ptr(), out[2].data_ptr(), _stream(a.device))
    _build.check(rc, "lcp_pairs")
    lcp_pairs.launches += 1
    return out


@torch.library.custom_op("repro_torch::lcp_pairs", mutates_args=())
def _lcp_pairs_op(a: torch.Tensor, b: torch.Tensor, w: int) -> torch.Tensor:
    return _lcp_pairs_impl(a, b, w)


@_lcp_pairs_op.register_fake
def _(a, b, w):
    return a.new_empty((3, a.shape[0]), dtype=torch.int32)

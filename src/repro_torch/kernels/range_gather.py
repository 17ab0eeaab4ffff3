"""Wrapper of the byte-key gather CUDA kernel (elastic-range sort keys).

:func:`range_gather_pack` runs ``csrc/range_gather_pack.cu``, the port of
``repro/kernels/range_gather.py:range_gather_pack``, for CUDA tensors and
the plain version (:func:`repro_torch.kernels.ref.range_gather_pack_ref`)
for CPU tensors; an optional row mask zeroes rows in the kernel.
Launches are counted in ``range_gather_pack.launches``,
and the rows and key words they gathered in ``range_gather_pack.rows``
and ``range_gather_pack.words`` (the kernel's time scales with them, so a
launch count alone does not say what the launches cost).

Fake tensors, DTensors and dispatch modes reach the launch through the
custom op ``repro_torch::range_gather_pack``, whose fake implementation
gives the keys' shape and launches nothing (the dry run);
:func:`repro_torch.kernels.packed_gather.register_sharding_rules` gives
DTensor its row sharding.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.packed_gather import (
    _check_mask,
    _direct,
    _on_cpu,
    _ptr,
    _require,
    _stream,
)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int


def require_byte_text(s: torch.Tensor) -> None:
    """The byte kernels read the string as 4-byte aligned uint8 codes."""
    _require(s, "s_padded", torch.uint8, 1)
    if s.data_ptr() % 4 or s.shape[0] == 0:
        raise ValueError("s_padded must be a non-empty 4-byte aligned "
                         "uint8 tensor (a fresh upload is)")


def range_gather_pack(s_padded: torch.Tensor, offs: torch.Tensor, w: int,
                      mask: torch.Tensor | None = None) -> torch.Tensor:
    """(F, w//4) int32 big-endian byte keys (uint32 bit patterns) of the
    ``w`` symbols at each offset, every symbol index clamped to
    ``len(s_padded) - 1`` — bit-identical to
    :func:`repro_torch.core.packing.gather_pack`.

    ``s_padded``: the terminal-padded uint8 string; ``offs``: int32[F]
    offsets ``>= 0``.  ``mask``: bool[F] or None; a row whose mask is
    False is all zero words and reads no text.
    """
    if w % 4:
        raise ValueError(f"pack width must be a multiple of 4, got {w}")
    _on_cpu(s_padded, offs, mask)
    if _direct(s_padded, offs, mask):
        return _range_gather_pack_impl(s_padded, offs, w // 4, mask)
    return torch.ops.repro_torch.range_gather_pack(s_padded, offs, w // 4,
                                                   mask)


range_gather_pack.launches = 0
range_gather_pack.rows = 0
range_gather_pack.words = 0


def _range_gather_pack_impl(s_padded: torch.Tensor, offs: torch.Tensor,
                            nw: int,
                            mask: torch.Tensor | None) -> torch.Tensor:
    """The kernel launch on CUDA tensors, the plain version on CPU ones."""
    if _on_cpu(s_padded, offs, mask):
        return _ref.range_gather_pack_ref(s_padded, offs, 4 * nw, mask)
    require_byte_text(s_padded)
    _require(offs, "offs", torch.int32, 1)
    f = offs.shape[0]
    _check_mask(mask, f)
    out = torch.empty((f, nw), dtype=torch.int32, device=offs.device)
    if f == 0:
        return out
    fn = _build.entry("range_gather_pack",
                      [_P, _I64, _P, _I64, _I32, _P, _P, _P])
    with torch.cuda.device(offs.device):
        rc = fn(s_padded.data_ptr(), s_padded.shape[0], offs.data_ptr(), f,
                nw, _ptr(mask), out.data_ptr(), _stream(offs.device))
    _build.check(rc, "range_gather_pack")
    range_gather_pack.launches += 1
    range_gather_pack.rows += f
    range_gather_pack.words += f * nw
    return out


@torch.library.custom_op("repro_torch::range_gather_pack", mutates_args=())
def _range_gather_pack_op(s_padded: torch.Tensor, offs: torch.Tensor,
                          nw: int, mask: torch.Tensor | None) -> torch.Tensor:
    return _range_gather_pack_impl(s_padded, offs, nw, mask)


@_range_gather_pack_op.register_fake
def _(s_padded, offs, nw, mask):
    return offs.new_empty((offs.shape[0], nw))

"""Wrapper of the flash-attention CUDA kernel (the LM prefill's attention).

:func:`flash_attention` runs ``csrc/flash_attention.cu``, the port of
``repro/kernels/flash_attention.py:flash_attention``, for CUDA tensors and
the plain version (:func:`repro_torch.kernels.ref.flash_attention_ref`)
for CPU tensors.  It keeps the JAX layout and flag; the Pallas kernel's
``blk_q``/``blk_k`` were TPU tiling, and the CUDA kernel picks its own
tiles.  Launches are counted in ``flash_attention.launches``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.packed_gather import _on_cpu, _stream

_P = ctypes.c_void_p
_I32 = ctypes.c_int
_DTYPES = (torch.float32, torch.bfloat16)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """(B, Sq, H, D) attention in ``q.dtype`` of q (B, Sq, H, D) over k/v
    (B, Sk, KV, D), H a multiple of KV (query head h reads KV head
    ``h // (H // KV)``), scale 1/sqrt(D), float32 sums.  With ``causal``,
    row i sees keys j <= i, both counted from 0 (also when Sq != Sk).

    On the card the inputs must be contiguous, all float32 or all
    bfloat16, with D a multiple of 16 up to 256 and Sq, Sk >= 1.
    """
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention needs q (B, Sq, H, D) and k, v "
                         f"(B, Sk, KV, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    kb, sk, kvh, kd = k.shape
    if kb != b or kd != d or kvh == 0 or h % kvh:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)} (H a multiple of KV)")
    if _on_cpu(q, k, v):
        return _ref.flash_attention_ref(q, k, v, causal)
    if d % 16 or not 16 <= d <= 256:
        raise ValueError(f"flash_attention takes head widths that are a "
                         f"multiple of 16 up to 256, got D={d}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention needs q, k, v all float32 or all "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    if min(b, sq, sk) < 1 or max(b, h) > 65535:
        raise ValueError(f"flash_attention needs 1 <= B, H <= 65535 and "
                         f"Sq, Sk >= 1, got {tuple(q.shape)}, {tuple(k.shape)}")
    out = torch.empty_like(q)
    fn = _build.entry("flash_attention",
                      [_P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32, _I32,
                       _I32, _I32, ctypes.c_float, _P])
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                sq, sk, h, kvh, d, int(causal),
                int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(d),
                _stream(q.device))
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

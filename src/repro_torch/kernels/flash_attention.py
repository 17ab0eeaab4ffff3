"""Wrapper of the flash-attention CUDA kernels (the LM prefill's attention).

:func:`flash_attention` is the port of
``repro/kernels/flash_attention.py:flash_attention``.  For CUDA tensors it
runs one of two hand-written kernels, chosen by dtype (:data:`ROUTES`):
bfloat16 runs ``csrc/flash_attention_sm90.cu`` (design ``wgmma_tma``:
tensor-core tiles fed by TMA), float32 runs ``csrc/flash_attention.cu``
(design ``cuda_cores``).  Neither gives way to the other or to the plain
version: a failed build or launch raises.  CPU tensors run the plain
version (:func:`repro_torch.kernels.ref.flash_attention_ref`).  It keeps
the JAX layout and flag; the Pallas kernel's ``blk_q``/``blk_k`` were TPU
tiling, and the CUDA kernels pick their own tiles.  Launches of both
routes are counted in ``flash_attention.launches``, and
``flash_attention.route`` names the design of the last launch.
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
# dtype -> (design, C entry point = library name in csrc/)
ROUTES = {torch.bfloat16: ("wgmma_tma", "flash_attention_sm90"),
          torch.float32: ("cuda_cores", "flash_attention")}
_SIG = [_P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32, _I32, _I32,
        ctypes.c_float, _P]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """(B, Sq, H, D) attention in ``q.dtype`` of q (B, Sq, H, D) over k/v
    (B, Sk, KV, D), H a multiple of KV (query head h reads KV head
    ``h // (H // KV)``), scale 1/sqrt(D), float32 sums.  With ``causal``,
    row i sees keys j <= i, both counted from 0 (also when Sq != Sk).

    On the card the inputs must be contiguous, all float32 or all
    bfloat16, with D a multiple of 16 up to 256 and Sq, Sk >= 1.  bfloat16
    runs the ``wgmma_tma`` kernel (inputs not 16-byte aligned, as a view
    at an odd offset can be, are copied first for its TMA loads); float32
    runs the ``cuda_cores`` kernel.
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
    if q.dtype not in ROUTES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention needs q, k, v all float32 or all "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    if min(b, sq, sk) < 1 or max(b, h) > 65535:
        raise ValueError(f"flash_attention needs 1 <= B, H <= 65535 and "
                         f"Sq, Sk >= 1, got {tuple(q.shape)}, {tuple(k.shape)}")
    design, lib = ROUTES[q.dtype]
    scale = 1.0 / math.sqrt(d)
    if design == "wgmma_tma":
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v))
        scale *= math.log2(math.e)  # the kernel takes exp2
    out = torch.empty_like(q)
    fn = _build.entry(lib, _SIG)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                sq, sk, h, kvh, d, int(causal), scale, _stream(q.device))
    _build.check(rc, lib)
    flash_attention.launches += 1
    flash_attention.route = design
    return out


flash_attention.launches = 0
flash_attention.route = None

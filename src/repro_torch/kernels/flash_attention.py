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

The launch is also the custom op ``repro_torch::flash_attention``, which
a call takes when it gets fake tensors or DTensors or runs under a
dispatch mode (plain calls launch directly, without the op's host
dispatch): its CUDA tensors launch the kernel, its CPU tensors run the
plain version, and its fake implementation (the dry run,
:mod:`repro_torch.launch.dryrun`) gives the output's shape, dtype and
device, reads nothing and launches nothing.
Its FLOPs are SDPA's count for the same shapes, causal or not (the count
``torch.utils.flop_counter`` gives ``scaled_dot_product_attention``), and
:func:`register_sharding_rules` gives DTensor its sharding: batch- or
head-sharded q/k/v give the same sharding out, with no collective.
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch.utils.flop_counter import register_flop_formula, sdpa_flop_count

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.packed_gather import _direct, _on_cpu, _stream

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
        return _call(q, k, v, causal)
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
    return _call(q, k, v, causal)


def _call(q, k, v, causal: bool) -> torch.Tensor:
    if _direct(q, k, v):
        return _flash_attention_impl(q, k, v, causal)
    return torch.ops.repro_torch.flash_attention(q, k, v, causal)


flash_attention.launches = 0
flash_attention.route = None


def _flash_attention_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool) -> torch.Tensor:
    """The kernel launch on CUDA tensors, the plain version on CPU ones."""
    if _on_cpu(q, k, v):
        return _ref.flash_attention_ref(q, k, v, causal)
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
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


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool) -> torch.Tensor:
    return _flash_attention_impl(q, k, v, causal)


@_flash_attention_op.register_fake
def _(q, k, v, causal):
    if k.shape[2] == 0 or q.shape[2] % k.shape[2]:  # a split of the heads
        raise ValueError(f"flash_attention: {q.shape[2]} query heads over "
                         f"{k.shape[2]} KV heads")
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_attention_flops(q_shape, k_shape, v_shape, *args, out_shape=None,
                           **kwargs) -> int:
    """SDPA's count in its (B, H, S, D) layout, the keys read once per
    query head (GQA's KV heads broadcast); the mask does not change it."""
    b, sq, h, d = q_shape
    sk = k_shape[1]
    return sdpa_flop_count((b, h, sq, d), (b, h, sk, d),
                           (b, h, sk, v_shape[3]))


def register_sharding_rules() -> None:
    """DTensor's sharding of ``repro_torch::flash_attention`` on one mesh
    dimension: replicated, or q/k/v and the output all sharded on the
    batch (dim 0) or all on the heads (dim 2; DTensor offers it only
    where both head counts divide, which keeps query head h reading KV
    head ``h // (H // KV)`` on every shard)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.flash_attention.default)
    def _rule(q, k, v, causal):
        rep = Replicate()
        rules = [([rep], [rep, rep, rep, None])]
        for dim in (0, 2):
            rules.append(([Shard(dim)], [Shard(dim), Shard(dim), Shard(dim),
                                         None]))
        return rules

"""Parameter specs and neural layers (the port of ``repro.models.nn``).

Every parameter is declared once as a :class:`Spec` carrying its shape and
its logical axes, exactly as in the JAX package, and :func:`init_params`
materializes a Spec tree into a nested dictionary of tensors.  Layers are
plain functions ``f(params_dict, inputs, cfg, ...)`` over tensors in the
JAX package's layouts (``wq`` (d, H, hd), ``wo`` (H, hd, d), activations
(B, S, d)), so a parameter tree converted from the JAX package runs
unchanged.

The prefill self-attention of a global layer from an empty cache, and a
bidirectional self-attention with no cache (the encdec encoder), run the
hand-written ``flash_attention`` kernel (:func:`attention`); everything
else, and training (``use_flash=False``), attends through :func:`_sdpa`,
the counterpart of the JAX package's plain attention.  :func:`mla_attention` keeps JAX's
up-projected form (its qk width differs from its v width, so it attends
through its own masked softmax), and :func:`moe` is JAX's capacity-based,
sort-free scatter with the expert products as batched einsums.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig


# ---------------------------------------------------------------------------
# Spec system
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Spec:
    shape: tuple
    axes: tuple  # logical axis names (len == len(shape)); None = replicated
    init: str = "normal"  # normal | zeros | ones
    scale: float | None = None  # None -> 1/sqrt(fan_in)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def map_specs(fn, tree: Any) -> Any:
    """``fn`` applied to every Spec of a nested dictionary, in sorted key
    order (the order ``jax.tree`` flattens a dictionary in)."""
    if isinstance(tree, Spec):
        return fn(tree)
    return {k: map_specs(fn, tree[k]) for k in sorted(tree)}


def stack_specs(tree: Any, n: int) -> Any:
    """Prepend a ``layers`` dimension to every Spec (for layer stacks)."""
    return map_specs(
        lambda s: Spec((n,) + s.shape, ("layers",) + s.axes, s.init, s.scale),
        tree)


def axes_tree(tree: Any) -> Any:
    """The logical-axes tree matching ``init_params`` output."""
    return map_specs(lambda s: s.axes, tree)


def init_params(tree: Any, dtype=torch.float32, device="cuda",
                seed: int = 0) -> Any:
    """Materialize a Spec tree into tensors on ``device``: zeros, ones, or
    float32 normals times ``scale`` (default 1/sqrt(fan_in), fan_in =
    ``shape[-2]``) cast to ``dtype``, drawn in flattening order from one
    ``torch.Generator`` on the device seeded with ``seed``.  The numbers
    differ from the JAX package's (another generator); tests carry JAX
    parameters across with ``transformer.params_from_numpy``."""
    dev = ops.resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def make(s: Spec) -> torch.Tensor:
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dtype, device=dev)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dtype, device=dev)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else max(1, s.shape[-1])
        scale = s.scale if s.scale is not None else 1.0 / math.sqrt(fan_in)
        x = torch.randn(s.shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return (x * scale).to(dtype)

    return map_specs(make, tree)


# ---------------------------------------------------------------------------
# Elementary ops
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + w.to(torch.float32))).to(x.dtype)


def rope_tables(positions: torch.Tensor, dim: int, theta: float):
    """cos/sin tables: positions (…,) -> (…, dim//2), in float32 as JAX
    computes them (``log(theta)`` taken in float32 too)."""
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32,
                                       device=positions.device))
    freqs = torch.exp(-log_theta * torch.arange(
        0, dim, 2, dtype=torch.float32, device=positions.device) / dim)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, D//2) or (S, D//2)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    while cos.dim() < x1.dim():  # broadcast over heads
        cos = cos[..., None, :]
        sin = sin[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int = 0,
                is_global: bool = True) -> torch.Tensor:
    """(…, Sq, Sk) boolean mask.  ``window`` <= 0 or ``is_global`` = full
    causal; else sliding-window causal.  ``window`` and ``is_global`` are
    host values (the JAX package traces them)."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    causal = diff >= 0
    if window > 0 and not is_global:
        return causal & (diff < max(window, 1))
    return causal


def _sdpa(q, k, v, mask, *, kv_groups: int) -> torch.Tensor:
    """q: (B,Sq,H,D); k/v: (B,Sk,KV,D); H = KV * kv_groups.

    GQA is computed in grouped form without materializing repeated K/V.
    """
    b, sq, h, d = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, kv_groups, d)
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k) * scale
    logits = logits.to(torch.float32)
    neg = torch.finfo(torch.float32).min
    while mask.dim() < logits.dim():  # (…,Sq,Sk) -> (B,KV,G,Sq,Sk)
        mask = mask[None]
    logits = torch.where(mask, logits, neg)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, sq, h, d)


# ---------------------------------------------------------------------------
# Attention (GQA + qk-norm + bias + sliding window; KV cache)
# ---------------------------------------------------------------------------

def attention_specs(cfg: ModelConfig, cross: bool = False) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = {
        "wq": Spec((d, h, hd), ("embed", "heads", "head")),
        "wk": Spec((d, kv, hd), ("embed", "kv_heads", "head")),
        "wv": Spec((d, kv, hd), ("embed", "kv_heads", "head")),
        "wo": Spec((h, hd, d), ("heads", "head", "embed")),
    }
    if cfg.qkv_bias and not cross:
        s["bq"] = Spec((h, hd), ("heads", "head"), "zeros")
        s["bk"] = Spec((kv, hd), ("kv_heads", "head"), "zeros")
        s["bv"] = Spec((kv, hd), ("kv_heads", "head"), "zeros")
    if cfg.qk_norm and not cross:
        s["q_norm"] = Spec((hd,), (None,), "zeros")
        s["k_norm"] = Spec((hd,), (None,), "zeros")
    return s


def attention(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    q_pos: torch.Tensor,         # (B, Sq) absolute positions
    window: int = 0,
    is_global: bool = True,
    cache: tuple | None = None,  # (k_cache, v_cache) (B, S_max, KV, hd)
    cache_index: int | None = None,  # host write position
    kv_source: torch.Tensor | None = None,  # cross-attention memory (B, Sk, d)
    bidirectional: bool = False,
    use_flash: bool = True,
):
    """Returns (y, new_cache).

    The cache tensors are written in place (``new_cache`` holds the same
    tensors): the JAX package returns updated copies, which would double
    the cache's memory here.  A prefill self-attention from an empty cache
    (``cache_index == 0``) of a global or unwindowed layer attends through
    the ``flash_attention`` kernel over the keys just written; its mask
    then equals the causal mask over the valid cache.  A bidirectional
    self-attention with no cache (the encdec encoder) runs the kernel's
    full mode, where the JAX package masks nothing.  The choice reads host
    values only, never a build or launch error.  ``use_flash=False`` (the
    training forward, since the kernel has no backward) sends those cases
    through :func:`_sdpa` too.
    """
    b, sq, d = x.shape
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    src = x if kv_source is None else kv_source

    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("btd,dhk->bthk", src, p["wk"])
    v = torch.einsum("btd,dhk->bthk", src, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)

    hd = cfg.head_dim
    if kv_source is None:  # rope only for self-attention
        cos, sin = rope_tables(q_pos, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    if use_flash and cache is None and bidirectional and kv_source is None:
        out = ops.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=False)
        return torch.einsum("bshk,hkd->bsd", out, p["wo"]), None
    flash = (use_flash and cache is not None and cache_index == 0
             and kv_source is None and not bidirectional
             and (is_global or window <= 0))
    if cache is not None:
        k_cache, v_cache = cache
        # the start clamped as jax.lax.dynamic_update_slice clamps it: a
        # write past the end overwrites the last sq slots (a prompt longer
        # than the cache still fails on the shapes); the mask below is not
        # clamped, as in the JAX package
        start = max(0, min(cache_index, k_cache.shape[1] - sq))
        k_cache[:, start:start + sq] = k.to(k_cache.dtype)
        v_cache[:, start:start + sq] = v.to(v_cache.dtype)
        new_cache = (k_cache, v_cache)
        if flash:  # the keys as cached, in the compute dtype
            out = ops.flash_attention(
                q.contiguous(), k.to(k_cache.dtype).to(q.dtype).contiguous(),
                v.to(v_cache.dtype).to(q.dtype).contiguous(), causal=True)
            return torch.einsum("bshk,hkd->bsd", out, p["wo"]), new_cache
        k, v = k_cache, v_cache
        k_pos = torch.arange(k.shape[1], dtype=torch.int32, device=x.device)[None, :]
        valid = k_pos <= (cache_index + sq - 1)
        mask = causal_mask(q_pos, k_pos, window, is_global) & valid[:, None, :]
    else:
        new_cache = None
        if bidirectional or kv_source is not None:
            mask = torch.ones((b, sq, k.shape[1]), dtype=torch.bool,
                              device=x.device)
        else:
            mask = causal_mask(q_pos, q_pos, window, is_global)

    # mask: (B, Sq, Sk) -> (B, 1, 1, Sq, Sk) broadcasting over (KV, G)
    out = _sdpa(q, k, v, mask[:, None, None, :, :], kv_groups=h // kvh)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, new_cache


# ---------------------------------------------------------------------------
# Dense SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    return {
        "w_gate": Spec((d, f), ("embed", "mlp")),
        "w_up": Spec((d, f), ("embed", "mlp")),
        "w_down": Spec((f, d), ("mlp", "embed")),
    }


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(torch.einsum("bsd,df->bsf", x, p["w_gate"]))
    u = torch.einsum("bsd,df->bsf", x, p["w_up"])
    return torch.einsum("bsf,fd->bsd", g * u, p["w_down"])


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (DeepSeek-V2)
# ---------------------------------------------------------------------------

# Above this many bytes of float32 logits for the whole batch, MLA attends
# one batch row at a time (rows are independent: the same result).
MLA_LOGIT_BYTES = 2 << 30


def mla_specs(cfg: ModelConfig) -> dict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    ql, kvl, rd = cfg.q_lora, cfg.kv_lora, cfg.rope_dims
    s = {
        "w_dkv": Spec((d, kvl), ("embed", "kv_lora")),
        "kv_norm": Spec((kvl,), (None,), "zeros"),
        "w_uk": Spec((kvl, h, hd), ("kv_lora", "heads", "head")),
        "w_uv": Spec((kvl, h, hd), ("kv_lora", "heads", "head")),
        "w_kr": Spec((d, rd), ("embed", None)),
        "wo": Spec((h, hd, d), ("heads", "head", "embed")),
    }
    if ql:
        s["w_dq"] = Spec((d, ql), ("embed", None))
        s["q_norm"] = Spec((ql,), (None,), "zeros")
        s["w_uq"] = Spec((ql, h, hd), (None, "heads", "head"))
        s["w_uqr"] = Spec((ql, h, rd), (None, "heads", None))
    else:
        s["w_uq"] = Spec((d, h, hd), ("embed", "heads", "head"))
        s["w_uqr"] = Spec((d, h, rd), ("embed", "heads", None))
    return s


def _mla_attend(p, q_nope, q_rope, c_kv, k_rope, mask, scale):
    """JAX's up-projected ("naive") MLA attention of (B, Sq) queries over
    (B, Sk) cached latents: ``k_nope`` and ``v`` from ``c_kv``, float32
    logits masked to the float32 minimum, softmax, back to ``v.dtype``."""
    k_nope = torch.einsum("btl,lhk->bthk", c_kv, p["w_uk"])
    v = torch.einsum("btl,lhk->bthk", c_kv, p["w_uv"])
    logits = (torch.einsum("bshk,bthk->bhst", q_nope, k_nope)
              + torch.einsum("bshr,btr->bhst", q_rope, k_rope)) * scale
    logits = logits.to(torch.float32)
    neg = torch.finfo(torch.float32).min
    logits = torch.where(mask[:, None, :, :], logits, neg)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthk->bshk", probs, v)


def mla_attention(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    q_pos: torch.Tensor,
    cache: tuple | None = None,  # (c_kv (B,S,kvl), k_rope (B,S,rd))
    cache_index: int | None = None,
):
    """Returns (y, new_cache); the cache tensors are written in place at a
    start clamped as :func:`attention` clamps it.  The logits are
    (B, H, Sq, Sk) float32; past ``MLA_LOGIT_BYTES`` for the whole batch
    the batch rows attend one at a time."""
    b, sq, d = x.shape
    h, hd, rd = cfg.n_heads, cfg.head_dim, cfg.rope_dims

    if cfg.q_lora:
        cq = rms_norm(torch.einsum("bsd,dq->bsq", x, p["w_dq"]), p["q_norm"],
                      cfg.norm_eps)
    else:
        cq = x
    q_nope = torch.einsum("bsq,qhk->bshk", cq, p["w_uq"])
    q_rope = torch.einsum("bsq,qhr->bshr", cq, p["w_uqr"])
    cos, sin = rope_tables(q_pos, rd, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)

    c_kv = rms_norm(torch.einsum("bsd,dl->bsl", x, p["w_dkv"]), p["kv_norm"],
                    cfg.norm_eps)
    k_rope = torch.einsum("bsd,dr->bsr", x, p["w_kr"])
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]

    if cache is not None:
        ckv_cache, kr_cache = cache
        start = max(0, min(cache_index, ckv_cache.shape[1] - sq))
        ckv_cache[:, start:start + sq] = c_kv.to(ckv_cache.dtype)
        kr_cache[:, start:start + sq] = k_rope.to(kr_cache.dtype)
        c_kv, k_rope = ckv_cache, kr_cache
        k_pos = torch.arange(c_kv.shape[1], dtype=torch.int32,
                             device=x.device)[None, :]
        valid = k_pos <= (cache_index + sq - 1)
        mask = causal_mask(q_pos, k_pos) & valid[:, None, :]
        new_cache = (ckv_cache, kr_cache)
    else:
        mask = causal_mask(q_pos, q_pos)
        new_cache = None

    scale = 1.0 / math.sqrt(hd + rd)
    sk = c_kv.shape[1]
    rows = b if b * h * sq * sk * 4 <= MLA_LOGIT_BYTES else 1
    out = torch.cat([
        _mla_attend(p, q_nope[i:i + rows], q_rope[i:i + rows],
                    c_kv[i:i + rows], k_rope[i:i + rows], mask[i:i + rows],
                    scale)
        for i in range(0, b, rows)])
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, new_cache


# ---------------------------------------------------------------------------
# Top-k routed MoE (capacity-based, sort-free scatter)
# ---------------------------------------------------------------------------

def moe_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    e = cfg.n_experts
    fe = cfg.d_ff_expert or cfg.d_ff
    s = {
        "router": Spec((d, e), ("embed", None)),
        "w_gate": Spec((e, d, fe), ("experts", "embed", "mlp")),
        "w_up": Spec((e, d, fe), ("experts", "embed", "mlp")),
        "w_down": Spec((e, fe, d), ("experts", "mlp", "embed")),
    }
    if cfg.n_shared_experts:
        s["shared"] = mlp_specs(cfg, d_ff=fe * cfg.n_shared_experts)
    return s


def moe_route(p: dict, xt: torch.Tensor, cfg: ModelConfig):
    """The router of :func:`moe` on tokens ``xt`` (T, d): float32 softmax
    probabilities (T, E), and the top-k gates and expert ids (T, k).  The
    top k come from a stable descending sort, so equal probabilities keep
    the lower expert first, as ``jax.lax.top_k`` does (``torch.topk``'s tie
    order on the card is not JAX's)."""
    logits = torch.einsum("td,de->te", xt, p["router"]).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return probs, vals[:, :cfg.top_k], ids[:, :cfg.top_k]


def moe(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """Top-k routed MoE with fixed expert capacity (sort-free scatter).

    Returns (y, aux_loss).  Each assignment's slot is its rank among the
    assignments to its expert in token-major order (an exclusive cumsum
    of the (T*k, E) one-hot); those at or past the capacity are dropped
    and add zeros to slot (0, 0), as in the JAX package.  The expert
    products are batched einsums over the leading E axis, and the k
    outputs of a token are summed through a (T, k, d) view (the JAX
    package's scatter-add onto ``repeat(arange(T), k)``; no atomics)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(t, d)

    probs, gate_vals, ids = moe_route(p, xt, cfg)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # load-balancing aux loss (Switch-style)
    density = torch.mean(F.one_hot(ids[:, 0], e).to(torch.float32), dim=0)
    router_mean = torch.mean(probs, dim=0)
    aux = e * torch.sum(density * router_mean)

    cap = max(int(math.ceil(t * k / e * cfg.capacity_factor)), 4)

    flat_ids = ids.reshape(-1)                                  # (T*k,)
    flat_gate = gate_vals.reshape(-1)
    onehot = F.one_hot(flat_ids, e).to(torch.int32)             # (T*k, E)
    ranks = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    slot = torch.gather(ranks, 1, flat_ids[:, None])[:, 0]      # (T*k,)
    keep = slot < cap
    token_of = torch.arange(t, device=x.device).repeat_interleave(k)

    eids = torch.where(keep, flat_ids, 0)
    slts = torch.where(keep, slot.to(torch.int64), 0)
    contrib = torch.where(keep[:, None], xt[token_of], 0)
    buf = xt.new_zeros((e, cap, d))
    buf.index_put_((eids, slts), contrib, accumulate=True)

    g = F.silu(torch.einsum("ecd,edf->ecf", buf, p["w_gate"]))
    u = torch.einsum("ecd,edf->ecf", buf, p["w_up"])
    y_e = torch.einsum("ecf,efd->ecd", g * u, p["w_down"])

    out_flat = torch.where(keep[:, None], y_e[eids, slts], 0)
    out_flat = out_flat * flat_gate[:, None].to(xt.dtype)
    y = out_flat.view(t, k, d).sum(1)

    if cfg.n_shared_experts:
        y = y + mlp(p["shared"], x).reshape(t, d)
    return y.reshape(b, s, d), aux

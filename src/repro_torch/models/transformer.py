"""Model assembly for the dense and vlm families (the port of
``repro.models.transformer``).

The layer stack is a Python loop over the stacked per-layer tensors (the
JAX package scans them); the cache is a dictionary of stacked tensors
written in place, with its position ``pos`` a host integer.

Entry points:

* ``model_specs(cfg)``       — the parameter Spec tree
* ``init_params``            — random parameters on a device
* ``params_from_numpy``      — a JAX parameter tree (as numpy) → the port's
* ``init_cache(cfg, B, S)``  — the KV cache
* ``forward_train``          — full-sequence logits (+ the aux loss, zero)
* ``forward_prefill``        — logits for the last position + filled cache
* ``forward_decode``         — one-token step against the cache

The other families (moe and MLA, ssm, hybrid, encdec) raise
``NotImplementedError`` naming ROADMAP item A15c.
"""

from __future__ import annotations

import functools
import math
from typing import Any

import numpy as np
import torch
from torch.utils import checkpoint as ckpt

from repro_torch.kernels import ops
from repro_torch.models import nn
from repro_torch.models.config import ModelConfig
from repro_torch.models.nn import Spec

_FAMILIES = ("dense", "vlm")


def _require_family(cfg: ModelConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family ({cfg.name}) is not ported yet: "
            f"ROADMAP A15c (the moe/MLA, ssm, hybrid and encdec families); "
            f"the port runs {', '.join(_FAMILIES)}")


# ---------------------------------------------------------------------------
# Spec assembly
# ---------------------------------------------------------------------------

def _ln(cfg: ModelConfig) -> Spec:
    return Spec((cfg.d_model,), (None,), "zeros")


def _dense_block_specs(cfg: ModelConfig) -> dict:
    return {"ln1": _ln(cfg), "attn": nn.attention_specs(cfg), "ln2": _ln(cfg),
            "mlp": nn.mlp_specs(cfg)}


def model_specs(cfg: ModelConfig) -> dict:
    _require_family(cfg)
    d = cfg.d_model
    specs: dict[str, Any] = {
        "embed": Spec((cfg.vocab, d), ("vocab", "embed"), scale=1.0),
        "final_norm": _ln(cfg),
        "layers": nn.stack_specs(_dense_block_specs(cfg), cfg.n_layers),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = Spec((d, cfg.vocab), ("embed", "vocab"))
    if cfg.frontend:
        specs["frontend_proj"] = Spec((cfg.frontend_dim, d), (None, "embed"))
    return specs


def init_params(seed: int, cfg: ModelConfig, dtype=torch.float32,
                device="cuda"):
    """Random parameters of ``cfg`` on ``device`` from ``seed``."""
    return nn.init_params(model_specs(cfg), dtype, device, seed)


def params_from_numpy(tree: Any, cfg: ModelConfig, device="cuda",
                      dtype=None) -> Any:
    """The port's parameters from a JAX parameter tree converted to numpy
    (``jax.tree.map(np.asarray, T.init_params(...))``): the same nested
    dictionary and the same layouts (``wq`` (L, d, H, hd), ``wo`` (L, H,
    hd, d), …), each leaf checked against ``model_specs(cfg)``.  ``dtype``
    None keeps each array's own type."""
    dev = ops.resolve_device(device)

    def convert(spec: Any, node: Any, path: str) -> Any:
        if isinstance(spec, Spec):
            arr = np.asarray(node)
            if tuple(arr.shape) != tuple(spec.shape):
                raise ValueError(f"{path}: shape {arr.shape}, the model "
                                 f"expects {spec.shape}")
            t = torch.from_numpy(np.array(arr)).to(dev)  # a writable copy
            return t if dtype is None else t.to(dtype)
        if set(node) != set(spec):
            raise ValueError(f"{path or 'params'}: keys {sorted(node)}, the "
                             f"model expects {sorted(spec)}")
        return {k: convert(spec[k], node[k], f"{path}/{k}") for k in sorted(spec)}

    return convert(model_specs(cfg), tree, "")


def _layer(stacked: Any, i: int) -> Any:
    """Layer ``i``'s parameters: views into the stacked tensors."""
    if isinstance(stacked, torch.Tensor):
        return stacked[i]
    return {k: _layer(v, i) for k, v in stacked.items()}


# ---------------------------------------------------------------------------
# Blocks (forward)
# ---------------------------------------------------------------------------

def _dense_block(p, x, cfg: ModelConfig, *, q_pos, window, is_global,
                 cache=None, cache_index=None):
    h, kv = nn.attention(
        p["attn"], nn.rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
        q_pos=q_pos, window=window, is_global=is_global,
        cache=cache, cache_index=cache_index,
    )
    x = x + h
    x = x + nn.mlp(p["mlp"], nn.rms_norm(x, p["ln2"], cfg.norm_eps))
    return x, kv


def _is_global_flags(cfg: ModelConfig, n: int) -> list[bool]:
    if cfg.sliding_window and cfg.global_every:
        return [(i + 1) % cfg.global_every == 0 for i in range(n)]
    if cfg.sliding_window:
        return [False] * n
    return [True] * n


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------

def _embed_tokens(params, tokens, cfg: ModelConfig, dtype):
    scale = torch.tensor(math.sqrt(cfg.d_model), dtype=dtype,
                         device=tokens.device)  # keep compute dtype
    return params["embed"][tokens.to(torch.int64)].to(dtype) * scale


def _logits(params, x, cfg: ModelConfig):
    x = nn.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params["embed"].to(x.dtype))
    return torch.einsum("bsd,dv->bsv", x, params["unembed"].to(x.dtype))


def _frontend(params, batch, cfg: ModelConfig, dtype):
    """Prepend stub modality embeddings (patches) to token embeds."""
    emb = _embed_tokens(params, batch["tokens"], cfg, dtype)
    if cfg.frontend and "frontend" in batch:
        fr = torch.einsum("btf,fd->btd", batch["frontend"].to(dtype),
                          params["frontend_proj"].to(dtype))
        emb = torch.cat([fr, emb], dim=1)
    return emb


# ---------------------------------------------------------------------------
# Training forward (full sequence)
# ---------------------------------------------------------------------------

def _unstack(stacked: Any, n: int) -> list:
    """Per-layer parameter trees from the stacked tensors, through one
    ``torch.unbind`` per leaf: its backward stacks the layers' gradients
    once, where indexing each layer would scatter every layer's gradient
    into a zero tensor of the whole stack."""
    if isinstance(stacked, torch.Tensor):
        return list(torch.unbind(stacked, 0))
    per_key = {k: _unstack(v, n) for k, v in stacked.items()}
    return [{k: per_key[k][i] for k in per_key} for i in range(n)]


def _saves_dots(ctx, op, *args, **kwargs):
    """The ``"dots"`` remat policy, the counterpart of
    ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep the
    outputs of products without batch dimensions (``torch.einsum`` runs a
    weight product as a ``bmm`` over one batch; attention's products have
    (B, KV) batches) and recompute the rest."""
    if op is torch.ops.aten.mm.default or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _train_layer(x, lp, cfg: ModelConfig, q_pos, is_global: bool):
    y, _ = _dense_block(lp, x, cfg, q_pos=q_pos, window=cfg.sliding_window,
                        is_global=is_global)
    return y


def forward_train(params, batch, cfg: ModelConfig, *, remat: bool = True,
                  remat_policy: str = "none"):
    """Returns (logits, aux_loss); aux is a float32 zero for these
    families, as in the JAX package.

    With ``remat`` each layer body runs under
    ``torch.utils.checkpoint.checkpoint`` (non-reentrant): only its input
    is kept for the backward, which recomputes the rest
    (``jax.checkpoint``); ``remat_policy="dots"`` keeps the weight
    products' outputs too (:func:`_saves_dots`).  Attention is
    :func:`nn._sdpa` (no cache: never the ``flash_attention`` kernel,
    which has no backward), differentiated by autograd."""
    _require_family(cfg)
    dtype = params["final_norm"].dtype
    x = _frontend(params, batch, cfg, dtype)
    b, s, _ = x.shape
    q_pos = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    context_fn = ckpt.noop_context_fn
    if remat_policy == "dots":
        context_fn = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _saves_dots)
    flags = _is_global_flags(cfg, cfg.n_layers)
    for lp, is_g in zip(_unstack(params["layers"], cfg.n_layers), flags):
        if remat:
            x = ckpt.checkpoint(_train_layer, x, lp, cfg, q_pos, is_g,
                                use_reentrant=False, context_fn=context_fn)
        else:
            x = _train_layer(x, lp, cfg, q_pos, is_g)

    return _logits(params, x, cfg), aux_total


# ---------------------------------------------------------------------------
# Cache, prefill and decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    _require_family(cfg)
    dev = ops.resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev), "pos": 0}


def _run_layers(params, x, cfg: ModelConfig, cache, q_pos, idx: int):
    flags = _is_global_flags(cfg, cfg.n_layers)
    for i in range(cfg.n_layers):
        x, _ = _dense_block(_layer(params["layers"], i), x, cfg, q_pos=q_pos,
                            window=cfg.sliding_window, is_global=flags[i],
                            cache=(cache["k"][i], cache["v"][i]),
                            cache_index=idx)
    return x


def forward_prefill(params, batch, cfg: ModelConfig, cache):
    """Fill the cache with the prompt; return (last-position logits, cache).
    The cache's tensors are written in place."""
    _require_family(cfg)
    dtype = params["final_norm"].dtype
    idx = int(cache["pos"])
    x = _frontend(params, batch, cfg, dtype)
    b, s, _ = x.shape
    q_pos = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s) + idx
    x = _run_layers(params, x, cfg, cache, q_pos, idx)
    new_cache = {"k": cache["k"], "v": cache["v"], "pos": idx + s}
    return _logits(params, x[:, -1:], cfg), new_cache


def forward_decode(params, token, cfg: ModelConfig, cache):
    """One decode step.  token: (B, 1) int32.  Returns (logits, cache).
    The cache's tensors are written in place."""
    _require_family(cfg)
    dtype = params["final_norm"].dtype
    idx = int(cache["pos"])
    x = _embed_tokens(params, token, cfg, dtype)
    b = x.shape[0]
    q_pos = torch.full((b, 1), idx, dtype=torch.int32, device=x.device)
    x = _run_layers(params, x, cfg, cache, q_pos, idx)
    new_cache = {"k": cache["k"], "v": cache["v"], "pos": idx + 1}
    return _logits(params, x, cfg), new_cache

"""Model assembly for every family (the port of
``repro.models.transformer``): dense and vlm, moe (GQA or MLA attention,
optional leading dense layers), ssm (Mamba-1), hybrid (Mamba-2 chunks,
each followed by ONE shared attention block) and encdec (a bidirectional
encoder over the frontend, a decoder with cross-attention).

The layer stack is a Python loop over the stacked per-layer tensors (the
JAX package scans them); the cache is a dictionary of stacked tensors
written in place, with its position ``pos`` a host integer.

Entry points:

* ``model_specs(cfg)``       — the parameter Spec tree
* ``init_params``            — random parameters on a device
* ``params_from_numpy``      — a JAX parameter tree (as numpy) → the port's
* ``init_cache(cfg, B, S)``  — the cache, with the JAX package's keys
* ``forward_train``          — full-sequence logits (+ the MoE aux loss)
* ``forward_prefill``        — logits for the last position + filled cache
* ``forward_decode``         — one-token step against the cache
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Any

import numpy as np
import torch
from torch.utils import checkpoint as ckpt

from repro_torch.kernels import ops
from repro_torch.models import nn, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.nn import Spec

# ---------------------------------------------------------------------------
# Optional activation-sharding constraint (sequence parallelism).
#
# For archs whose head count does not divide the model axis (qwen3-14b /
# qwen1.5-32b: 40 heads on 16), TP cannot shard attention; constraining
# activations to (batch→data, seq→model) shards the S² work instead (the
# dry run's ``sp`` variant).  The layer loops are always unrolled here, so
# JAX's ``unrolled_layers`` has no counterpart.
# ---------------------------------------------------------------------------

_ACT_SPEC = None


@contextlib.contextmanager
def activation_sharding(spec):
    """spec: a (B, S, D) spec (:mod:`repro_torch.sharding`), or None."""
    global _ACT_SPEC
    old = _ACT_SPEC
    _ACT_SPEC = spec
    try:
        yield
    finally:
        _ACT_SPEC = old


def _constrain(x):
    """``jax.lax.with_sharding_constraint``: a (B, S, D) DTensor
    redistributed to the active spec's placements; plain tensors, and
    every tensor outside :func:`activation_sharding`, pass unchanged."""
    if _ACT_SPEC is None or x.dim() != 3 or not hasattr(x, "device_mesh"):
        return x
    from repro_torch.sharding import placements

    return x.redistribute(x.device_mesh, placements(_ACT_SPEC, x.device_mesh))


# ---------------------------------------------------------------------------
# Spec assembly
# ---------------------------------------------------------------------------

def _ln(cfg: ModelConfig) -> Spec:
    return Spec((cfg.d_model,), (None,), "zeros")


def _dense_block_specs(cfg: ModelConfig, cross: bool = False) -> dict:
    s = {"ln1": _ln(cfg), "attn": nn.attention_specs(cfg), "ln2": _ln(cfg),
         "mlp": nn.mlp_specs(cfg)}
    if cross:
        s["lnx"] = _ln(cfg)
        s["xattn"] = nn.attention_specs(cfg, cross=True)
    return s


def _attn_specs(cfg: ModelConfig) -> dict:
    return nn.mla_specs(cfg) if cfg.mla else nn.attention_specs(cfg)


def _moe_block_specs(cfg: ModelConfig) -> dict:
    return {"ln1": _ln(cfg), "attn": _attn_specs(cfg), "ln2": _ln(cfg),
            "moe": nn.moe_specs(cfg)}


def _mamba_block_specs(cfg: ModelConfig) -> dict:
    mk = ssm.mamba2_specs if cfg.ssm == "mamba2" else ssm.mamba1_specs
    return {"ln": _ln(cfg), "ssm": mk(cfg)}


def model_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    specs: dict[str, Any] = {
        "embed": Spec((cfg.vocab, d), ("vocab", "embed"), scale=1.0),
        "final_norm": _ln(cfg),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = Spec((d, cfg.vocab), ("embed", "vocab"))
    if cfg.frontend:
        specs["frontend_proj"] = Spec((cfg.frontend_dim, d), (None, "embed"))

    fam = cfg.family
    if fam in ("dense", "vlm"):
        specs["layers"] = nn.stack_specs(_dense_block_specs(cfg), cfg.n_layers)
    elif fam == "moe":
        n_moe = cfg.n_layers - cfg.n_dense_layers
        if cfg.n_dense_layers:
            dense = {"ln1": _ln(cfg), "ln2": _ln(cfg),
                     "mlp": nn.mlp_specs(cfg), "attn": _attn_specs(cfg)}
            specs["dense_layers"] = nn.stack_specs(dense, cfg.n_dense_layers)
        specs["layers"] = nn.stack_specs(_moe_block_specs(cfg), n_moe)
    elif fam == "ssm":
        specs["layers"] = nn.stack_specs(_mamba_block_specs(cfg), cfg.n_layers)
    elif fam == "hybrid":
        assert cfg.attn_every and cfg.n_layers % cfg.attn_every == 0
        specs["layers"] = nn.stack_specs(_mamba_block_specs(cfg), cfg.n_layers)
        specs["shared_attn"] = _dense_block_specs(cfg)  # ONE shared block
    elif fam == "encdec":
        specs["enc_layers"] = nn.stack_specs(_dense_block_specs(cfg),
                                             cfg.n_enc_layers)
        specs["dec_layers"] = nn.stack_specs(
            _dense_block_specs(cfg, cross=True), cfg.n_dec_layers)
    else:
        raise ValueError(fam)
    return specs


def init_params(seed: int, cfg: ModelConfig, dtype=torch.float32,
                device="cuda"):
    """Random parameters of ``cfg`` on ``device`` from ``seed``."""
    return nn.init_params(model_specs(cfg), dtype, device, seed)


def param_logical_axes(cfg: ModelConfig):
    return nn.axes_tree(model_specs(cfg))


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
                 cache=None, cache_index=None, enc_out=None,
                 bidirectional=False, use_flash=True):
    x = _constrain(x)
    h, kv = nn.attention(
        p["attn"], nn.rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
        q_pos=q_pos, window=window, is_global=is_global,
        cache=cache, cache_index=cache_index, bidirectional=bidirectional,
        use_flash=use_flash,
    )
    x = x + h
    if enc_out is not None:
        hx, _ = nn.attention(
            p["xattn"], nn.rms_norm(x, p["lnx"], cfg.norm_eps), cfg,
            q_pos=q_pos, kv_source=enc_out,
        )
        x = x + hx
    x = x + nn.mlp(p["mlp"], nn.rms_norm(x, p["ln2"], cfg.norm_eps))
    return x, kv


def _moe_attention(p, x, cfg: ModelConfig, *, q_pos, cache, cache_index):
    """The moe family's attention: MLA, or GQA over the whole cache."""
    xn = nn.rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.mla:
        return nn.mla_attention(p["attn"], xn, cfg, q_pos=q_pos, cache=cache,
                                cache_index=cache_index)
    return nn.attention(p["attn"], xn, cfg, q_pos=q_pos, window=0,
                        is_global=True, cache=cache, cache_index=cache_index)


def _moe_block(p, x, cfg: ModelConfig, *, q_pos, cache=None, cache_index=None):
    h, kv = _moe_attention(p, x, cfg, q_pos=q_pos, cache=cache,
                           cache_index=cache_index)
    x = x + h
    y, aux = nn.moe(p["moe"], nn.rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
    return x + y, kv, aux


def _moe_dense_block(p, x, cfg: ModelConfig, *, q_pos, cache, cache_index):
    """A leading dense layer of the moe family (deepseek's first)."""
    h, kv = _moe_attention(p, x, cfg, q_pos=q_pos, cache=cache,
                           cache_index=cache_index)
    x = x + h
    x = x + nn.mlp(p["mlp"], nn.rms_norm(x, p["ln2"], cfg.norm_eps))
    return x, kv


def _mamba_block(p, x, cfg: ModelConfig, state=None, return_state=False):
    fn = ssm.mamba2 if cfg.ssm == "mamba2" else ssm.mamba1
    h, new_state = fn(p["ssm"], nn.rms_norm(x, p["ln"], cfg.norm_eps), cfg,
                      state, return_state=return_state)
    return x + h, new_state


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
    into a zero tensor of the whole stack.  A stack of one layer is
    squeezed instead, a view whose gradient is a view too (no copy of a
    deepseek-v2 MoE layer's 3.8 B expert weights' gradient)."""
    if isinstance(stacked, torch.Tensor):
        if n == 1:
            return [stacked.squeeze(0)]
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


def _train_moe_dense(x, lp, cfg: ModelConfig, q_pos):
    y, _ = _moe_dense_block(lp, x, cfg, q_pos=q_pos, cache=None,
                            cache_index=None)
    return y


def _train_moe(x, lp, cfg: ModelConfig, q_pos):
    y, _, aux = _moe_block(lp, x, cfg, q_pos=q_pos)
    return y, aux


def _train_mamba(x, lp, cfg: ModelConfig):
    return _mamba_block(lp, x, cfg)[0]


def _train_hybrid_chunk(x, chunk: list, shared, cfg: ModelConfig, q_pos):
    """One hybrid chunk: its ``attn_every`` Mamba-2 layers, then the one
    shared attention block."""
    for lp in chunk:
        x = _mamba_block(lp, x, cfg)[0]
    y, _ = _dense_block(shared, x, cfg, q_pos=q_pos, window=0,
                        is_global=True)
    return y


def _train_encoder(x, lp, cfg: ModelConfig, q_pos):
    """An encoder layer in training: bidirectional through ``_sdpa`` with
    the all-true mask (``use_flash=False``: the kernel has no backward)."""
    y, _ = _dense_block(lp, x, cfg, q_pos=q_pos, window=0, is_global=True,
                        bidirectional=True, use_flash=False)
    return y


def _train_decoder(x, lp, cfg: ModelConfig, q_pos, enc):
    y, _ = _dense_block(lp, x, cfg, q_pos=q_pos, window=0, is_global=True,
                        enc_out=enc)
    return y


def _run_layer(remat: bool, context_fn, fn, *args):
    """``fn(*args)``, under non-reentrant ``torch.utils.checkpoint`` with
    ``context_fn`` when ``remat`` is set."""
    if remat:
        return ckpt.checkpoint(fn, *args, use_reentrant=False,
                               context_fn=context_fn)
    return fn(*args)


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    return torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)


def forward_train(params, batch, cfg: ModelConfig, *, remat: bool = True,
                  remat_policy: str = "none"):
    """Returns (logits, aux_loss): aux is the float32 sum of the MoE
    layers' load-balancing losses, zero for every other family, as in the
    JAX package.

    With ``remat`` each layer body runs under
    ``torch.utils.checkpoint.checkpoint`` (non-reentrant): only its input
    is kept for the backward, which recomputes the rest
    (``jax.checkpoint``); ``remat_policy="dots"`` keeps the weight
    products' outputs too (:func:`_saves_dots`).  A hybrid's unit is a
    whole chunk (its Mamba-2 layers and the shared block); the encdec
    family checkpoints plainly whatever the policy (:func:`_encdec_train`).
    Attention is :func:`nn._sdpa` (never the ``flash_attention`` kernel,
    which has no backward), differentiated by autograd; the SSM scan
    through :class:`ssm.SSMScan`."""
    if cfg.family == "encdec":
        return _encdec_train(params, batch, cfg, remat)
    dtype = params["final_norm"].dtype
    x = _frontend(params, batch, cfg, dtype)
    q_pos = _positions(x)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    context_fn = ckpt.noop_context_fn
    if remat_policy == "dots":
        context_fn = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _saves_dots)
    run = functools.partial(_run_layer, remat, context_fn)

    fam = cfg.family
    if fam in ("dense", "vlm"):
        flags = _is_global_flags(cfg, cfg.n_layers)
        for lp, is_g in zip(_unstack(params["layers"], cfg.n_layers), flags):
            x = run(_train_layer, x, lp, cfg, q_pos, is_g)
    elif fam == "moe":
        n_dense = cfg.n_dense_layers
        if n_dense:
            for lp in _unstack(params["dense_layers"], n_dense):
                x = run(_train_moe_dense, x, lp, cfg, q_pos)
        for lp in _unstack(params["layers"], cfg.n_layers - n_dense):
            x, aux = run(_train_moe, x, lp, cfg, q_pos)
            aux_total = aux_total + aux
    elif fam == "ssm":
        for lp in _unstack(params["layers"], cfg.n_layers):
            x = run(_train_mamba, x, lp, cfg)
    elif fam == "hybrid":
        every = cfg.attn_every
        layers = _unstack(params["layers"], cfg.n_layers)
        for c in range(cfg.n_layers // every):  # layer c * every + i
            x = run(_train_hybrid_chunk, x, layers[c * every:(c + 1) * every],
                    params["shared_attn"], cfg, q_pos)
    else:
        raise ValueError(fam)
    return _logits(params, x, cfg), aux_total


def _encdec_train(params, batch, cfg: ModelConfig, remat: bool):
    """The encdec family's training forward (JAX's ``_encdec_train``): the
    frontend projection, every encoder layer bidirectional, then the
    decoder from position 0 with cross-attention on the encoder's output.
    ``remat`` checkpoints each layer plainly, as ``jax.checkpoint(ebody)``
    does, whatever the policy."""
    dtype = params["final_norm"].dtype
    enc = torch.einsum("btf,fd->btd", batch["frontend"].to(dtype),
                       params["frontend_proj"].to(dtype))
    run = functools.partial(_run_layer, remat, ckpt.noop_context_fn)
    enc_pos = _positions(enc)
    for lp in _unstack(params["enc_layers"], cfg.n_enc_layers):
        enc = run(_train_encoder, enc, lp, cfg, enc_pos)
    dec = _embed_tokens(params, batch["tokens"], cfg, dtype)
    q_pos = _positions(dec)
    for lp in _unstack(params["dec_layers"], cfg.n_dec_layers):
        dec = run(_train_decoder, dec, lp, cfg, q_pos, enc)
    return (_logits(params, dec, cfg),
            torch.zeros((), dtype=torch.float32, device=dec.device))


# ---------------------------------------------------------------------------
# Cache, prefill and decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """The cache of ``cfg``'s family with the JAX package's keys, shapes and
    dtypes: ``k``/``v`` (and a moe model's ``d_k``/``d_v`` for its leading
    dense layers) or MLA's ``ckv``/``kr`` (``d_ckv``/``d_kr``); the SSM
    states ``conv`` in ``dtype`` and ``h`` in float32, with a hybrid's
    ``k``/``v`` per chunk; encdec's ``enc``; ``pos`` a host int."""
    dev = ops.resolve_device(device)

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    fam = cfg.family
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    if fam in ("dense", "vlm"):
        shape = (cfg.n_layers, batch, max_len, kvh, hd)
        return {"k": zeros(*shape), "v": zeros(*shape), "pos": 0}
    if fam == "moe":
        n_moe, n_dense = cfg.n_layers - cfg.n_dense_layers, cfg.n_dense_layers
        if cfg.mla:
            c = {"ckv": zeros(n_moe, batch, max_len, cfg.kv_lora),
                 "kr": zeros(n_moe, batch, max_len, cfg.rope_dims), "pos": 0}
            if n_dense:
                c["d_ckv"] = zeros(n_dense, batch, max_len, cfg.kv_lora)
                c["d_kr"] = zeros(n_dense, batch, max_len, cfg.rope_dims)
            return c
        c = {"k": zeros(n_moe, batch, max_len, kvh, hd),
             "v": zeros(n_moe, batch, max_len, kvh, hd), "pos": 0}
        if n_dense:
            c["d_k"] = zeros(n_dense, batch, max_len, kvh, hd)
            c["d_v"] = zeros(n_dense, batch, max_len, kvh, hd)
        return c
    if fam in ("ssm", "hybrid"):
        di, n, k = cfg.d_inner, cfg.d_state, cfg.d_conv
        c = {"conv": zeros(cfg.n_layers, batch, k - 1, di), "pos": 0}
        if fam == "ssm":
            c["h"] = zeros(cfg.n_layers, batch, di, n, dt=torch.float32)
            return c
        nh = cfg.ssm_heads
        n_chunk = cfg.n_layers // cfg.attn_every
        c["h"] = zeros(cfg.n_layers, batch, nh, di // nh, n, dt=torch.float32)
        c["k"] = zeros(n_chunk, batch, max_len, kvh, hd)
        c["v"] = zeros(n_chunk, batch, max_len, kvh, hd)
        return c
    if fam == "encdec":
        shape = (cfg.n_dec_layers, batch, max_len, kvh, hd)
        return {"k": zeros(*shape), "v": zeros(*shape),
                "enc": zeros(batch, cfg.frontend_len, cfg.d_model), "pos": 0}
    raise ValueError(fam)


def _run_layers(params, x, cfg: ModelConfig, cache, q_pos, idx: int, *,
                prefill: bool, enc=None):
    """Every decoder layer of ``cfg``'s family over ``x``, writing the cache
    in place.  An SSM layer starts from no state in a prefill (the JAX
    package's full-sequence scan, its final state written to the cache)
    and from the cached state in decode.  A hybrid layer ``i`` belongs to
    chunk ``i // attn_every``; the shared block runs after each chunk with
    that chunk's KV cache."""
    fam = cfg.family
    if fam in ("dense", "vlm"):
        flags = _is_global_flags(cfg, cfg.n_layers)
        for i in range(cfg.n_layers):
            x, _ = _dense_block(_layer(params["layers"], i), x, cfg,
                                q_pos=q_pos, window=cfg.sliding_window,
                                is_global=flags[i],
                                cache=(cache["k"][i], cache["v"][i]),
                                cache_index=idx)
    elif fam == "encdec":
        for i in range(cfg.n_dec_layers):
            x, _ = _dense_block(_layer(params["dec_layers"], i), x, cfg,
                                q_pos=q_pos, window=0, is_global=True,
                                enc_out=enc,
                                cache=(cache["k"][i], cache["v"][i]),
                                cache_index=idx)
    elif fam == "moe":
        k1, k2 = ("ckv", "kr") if cfg.mla else ("k", "v")
        for i in range(cfg.n_dense_layers):
            x, _ = _moe_dense_block(
                _layer(params["dense_layers"], i), x, cfg, q_pos=q_pos,
                cache=(cache["d_" + k1][i], cache["d_" + k2][i]),
                cache_index=idx)
        for i in range(cfg.n_layers - cfg.n_dense_layers):
            x, _, _ = _moe_block(_layer(params["layers"], i), x, cfg,
                                 q_pos=q_pos,
                                 cache=(cache[k1][i], cache[k2][i]),
                                 cache_index=idx)
    elif fam in ("ssm", "hybrid"):
        every = cfg.attn_every if fam == "hybrid" else 0
        for i in range(cfg.n_layers):
            state = None if prefill else (cache["conv"][i], cache["h"][i])
            x, (conv, h) = _mamba_block(_layer(params["layers"], i), x, cfg,
                                        state, return_state=prefill)
            cache["conv"][i].copy_(conv)
            cache["h"][i].copy_(h)
            if every and (i + 1) % every == 0:
                c = i // every
                x, _ = _dense_block(params["shared_attn"], x, cfg,
                                    q_pos=q_pos, window=0, is_global=True,
                                    cache=(cache["k"][c], cache["v"][c]),
                                    cache_index=idx)
    return x


def _encode(params, frontend, cfg: ModelConfig, dtype):
    """The encdec encoder: ``frontend @ frontend_proj``, then every encoder
    layer bidirectional with no cache (the kernel's full mode)."""
    enc = torch.einsum("btf,fd->btd", frontend.to(dtype),
                       params["frontend_proj"].to(dtype))
    b, t, _ = enc.shape
    pos = torch.arange(t, dtype=torch.int32, device=enc.device)[None].expand(b, t)
    for i in range(cfg.n_enc_layers):
        enc, _ = _dense_block(_layer(params["enc_layers"], i), enc, cfg,
                              q_pos=pos, window=0, is_global=True,
                              bidirectional=True)
    return enc


def forward_prefill(params, batch, cfg: ModelConfig, cache):
    """Fill the cache with the prompt; return (last-position logits, cache).
    The cache's tensors are written in place.  For encdec the encoder runs
    over ``batch["frontend"]``, the decoder's positions start at 0 (as in
    the JAX package) and the cache keeps the encoder's output as
    ``enc``."""
    dtype = params["final_norm"].dtype
    idx = int(cache["pos"])
    enc, start = None, idx
    if cfg.family == "encdec":
        enc = _encode(params, batch["frontend"], cfg, dtype)
        x = _embed_tokens(params, batch["tokens"], cfg, dtype)
        start = 0
    else:
        x = _frontend(params, batch, cfg, dtype)
    b, s, _ = x.shape
    q_pos = (torch.arange(s, dtype=torch.int32, device=x.device)[None]
             .expand(b, s) + start)
    x = _run_layers(params, x, cfg, cache, q_pos, idx, prefill=True, enc=enc)
    new_cache = dict(cache, pos=idx + s)
    if enc is not None:
        new_cache["enc"] = enc.to(cache["enc"].dtype)
    return _logits(params, x[:, -1:], cfg), new_cache


def forward_decode(params, token, cfg: ModelConfig, cache):
    """One decode step.  token: (B, 1) int32.  Returns (logits, cache).
    The cache's tensors are written in place."""
    dtype = params["final_norm"].dtype
    idx = int(cache["pos"])
    x = _embed_tokens(params, token, cfg, dtype)
    b = x.shape[0]
    q_pos = torch.full((b, 1), idx, dtype=torch.int32, device=x.device)
    enc = cache["enc"].to(dtype) if cfg.family == "encdec" else None
    x = _run_layers(params, x, cfg, cache, q_pos, idx, prefill=False, enc=enc)
    return _logits(params, x, cfg), dict(cache, pos=idx + 1)

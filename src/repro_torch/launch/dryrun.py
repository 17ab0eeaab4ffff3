"""Multi-pod dry run: trace every (arch × shape × mesh) cell on fake
tensors over a fake process group — the port of ``repro.launch.dryrun``.

For each cell this shows that the distribution is coherent — the
shardings propagate through the port's own step functions, the
per-device program fits, the collective schedule exists — and reads the
roofline terms.  Torch has no compiled artefact to read, so the cell is
the port's eager step run once:

* inside :func:`repro_torch.launch.mesh.fake_world` (a ``"fake"`` process
  group of the mesh's size; this process is rank 0 and no collective
  moves data) on the production meshes of
  :func:`~repro_torch.launch.mesh.make_production_mesh`;
* on DTensors whose local shards are fake tensors (``FakeTensorMode``: a
  shape, a dtype and a device, no storage), placed by
  :mod:`repro_torch.sharding` as the JAX package places its arrays; the
  five hand kernels on the path (``flash_attention``, the three
  elastic-range gathers, ``lcp_pairs``) trace through their custom ops'
  fake implementations, launching nothing;
* under :class:`~repro_torch.roofline.counting.DeviceCounter`, which sees
  the local ops one device runs, DTensor's redistributions included, and
  records FLOPs, bytes, collectives and peak memory per device.

Where DTensor's own rule would not shard an op as XLA's per-device
program does, the dry run registers one (the SSM's depthwise convolution,
``argmax``) or, while a cell traces, runs the same computation written
for a split mesh (:func:`_traced_model`: GQA attention a device's heads at
a time, mamba2's heads a device's channels at a time, the embedding as a
masked lookup, the loss over a split vocab).
An op DTensor still cannot shard ends the cell ``error``, the op named;
nothing runs on gathered arguments behind DTensor's back.

Every layer is traced (the loops are eager), so the record's
``roofline`` is the full-depth count; JAX's ``roofline_raw_hlo`` (a scan
body counted once) has no counterpart and :func:`extrapolated_costs`, the
linear fit of two reduced-depth traces, only checks that the counts are
linear in depth.  The trace's wall time stands where JAX's
``t_lower_s`` / ``t_compile_s`` stand, as ``t_trace_s``.

The fake tensors claim ``--device`` (default ``cuda``; no card needed).
A torch built without CUDA cannot index a fake CUDA tensor (its CUDA
device guard is missing), so there they claim the CPU and the record says
``"device": "cpu"``; the counts are the same.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      [--arch qwen3-1.7b] [--shape train_4k] [--multi-pod {off,on,both}] \\
      [--out experiments/dryrun_torch.json] [--remat-policy none|dots]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import time
import traceback

import torch

from repro_torch import pytree
from repro_torch import sharding as shd
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import packed_gather as _gathers
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import nn, ssm
from repro_torch.models import transformer as T
from repro_torch.models.config import SHAPES
from repro_torch.models.registry import (
    ARCHS,
    cell_is_runnable,
    get_config,
    input_specs,
)
from repro_torch.optim import adamw
from repro_torch.roofline import analysis as roofline
from repro_torch.roofline.counting import DeviceCounter


def _abstract_params(cfg, dtype=torch.bfloat16):
    """The parameter tree as ``meta`` tensors (shapes and dtypes)."""
    return nn.map_specs(
        lambda s: torch.empty(s.shape, dtype=dtype, device="meta"),
        T.model_specs(cfg))


def _tokens_per_step(cfg, shape) -> float:
    if shape.kind == "train":
        return shape.global_batch * shape.seq_len
    return shape.global_batch * (shape.seq_len if shape.kind == "prefill" else 1)


def model_flops(cfg, shape) -> float:
    """Global useful FLOPs: 6·N_active·tokens (train) or 2·N_active·tokens."""
    n_active = cfg.active_param_count()
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * _tokens_per_step(cfg, shape)


def build_cell(cfg, shape, mesh, *, remat_policy: str = "none",
               dtype=torch.bfloat16, variant: str = "base"):
    """Returns (fn, args_abstract, in_shardings, out_shardings, donate):
    the arguments as ``meta`` trees, their NamedSharding trees.  The
    donated arguments are updated in place by the step itself (the train
    step is built with ``donate=True``; prefill and decode write the cache
    in place), and the outputs keep the placements they are computed in.

    variants:
      base     — the paper-faithful/naive distribution
      sp       — sequence parallelism: activations constrained to
                 (batch→data, seq→model) (:func:`trace_cell` sets it)
      seqcache — decode KV cache sequence dim sharded over model
    """
    params_abs = _abstract_params(cfg, dtype)
    p_shard = shd.param_shardings(T.model_specs(cfg), mesh)
    batch_abs = input_specs(cfg, shape, dtype=dtype)
    b_shard = shd.batch_shardings(mesh, batch_abs)

    if shape.kind == "train":
        opt_abs = adamw.init(params_abs)
        o_shard = adamw.AdamWState(step=shd.replicated(mesh), m=p_shard,
                                   v=p_shard)
        fn = steps.make_train_step(cfg, adamw.AdamWConfig(),
                                   remat_policy=remat_policy, donate=True)
        args = (params_abs, opt_abs, batch_abs)
        in_sh = (p_shard, o_shard, b_shard)
        return fn, args, in_sh, (p_shard, o_shard, None), (0, 1)

    seq_parallel = shape.name == "long_500k"
    cache_abs = _abstract_cache(cfg, shape.global_batch, shape.seq_len, dtype)
    c_shard = shd.cache_shardings(cfg, mesh, cache_abs,
                                  seq_parallel=seq_parallel)
    if variant == "seqcache":
        model_sz = shd.axis_sizes(mesh)["model"]

        def seq_over_model(x, s):
            if (isinstance(x, torch.Tensor) and x.dim() >= 4
                    and x.shape[2] % model_sz == 0):
                parts = list(s.spec) + [None] * (x.dim() - len(s.spec))
                parts[2] = "model"
                parts[-2] = None if parts[-2] == "model" else parts[-2]
                parts[-1] = None if parts[-1] == "model" else parts[-1]
                return shd.NamedSharding(mesh, tuple(parts))
            return s

        c_shard = {k: seq_over_model(cache_abs[k], c_shard[k])
                   for k in cache_abs}

    if shape.kind == "prefill":
        fn = steps.make_prefill_step(cfg)
        args = (params_abs, batch_abs, cache_abs)
        return fn, args, (p_shard, b_shard, c_shard), (None, c_shard), (2,)

    # decode: one token against a full cache (its last slot), so attention
    # reads every cached position, as JAX's decode at an abstract position
    # masks and reads them all
    cache_abs["pos"] = shape.seq_len - 1
    fn = steps.make_decode_step(cfg)
    args = (params_abs, batch_abs["tokens"], cache_abs)
    in_sh = (p_shard, shd.batch_sharding(mesh, shape.global_batch, 2),
             c_shard)
    return fn, args, in_sh, (None, c_shard), (2,)


def _abstract_cache(cfg, batch: int, max_len: int, dtype) -> dict:
    """``T.init_cache``'s tree as ``meta`` tensors (``pos`` the host 0):
    the cache is made on fake tensors, which hold no memory."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        cache = T.init_cache(cfg, batch, max_len, dtype, "cpu")
    return {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            if isinstance(v, torch.Tensor) else v for k, v in cache.items()}


# ---------------------------------------------------------------------------
# Tracing: fake tensors, DTensor placement, the per-device counter
# ---------------------------------------------------------------------------

_RULES_REGISTERED = False


def _register_rules() -> None:
    """DTensor's sharding of the hand kernels' custom ops and of the aten
    ops whose built-in rule does not cover the port's cells (registered
    once a process; they override DTensor's own rule for the op)."""
    global _RULES_REGISTERED
    if not _RULES_REGISTERED:
        _flash.register_sharding_rules()
        _gathers.register_sharding_rules()
        _register_argmax_rule()
        _register_index_put_rule()
        _RULES_REGISTERED = True


def _register_index_put_rule() -> None:
    """``aten.index_put_`` (MoE's dispatch into its expert buffer) with
    DTensor's strategy for ``index_put`` where it has none (torch 2.11
    shards only the functional form), less the strategies that would move
    the target (an in-place op keeps its placement): the indices
    replicated, the values split as the target on the dims they do not
    index."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor._ops import _tensor_ops
    from torch.distributed.tensor._ops.utils import register_op_strategy

    prop = DTensor._op_dispatcher.sharding_propagator
    op = torch.ops.aten.index_put_.default
    if op in prop.op_strategy_funcs or op in getattr(
            prop, "op_single_dim_strategy_funcs", {}):
        return

    @register_op_strategy(op, schema_info=RuntimeSchemaInfo(
        needs_pytree=True))
    def _in_place(op_schema):
        strategy = _tensor_ops.prop_index_put(op_schema)
        target = op_schema.args_schema[0].strategies[0].output_spec.placements
        strategy.strategies = [s for s in strategy.strategies
                               if s.output_spec.placements == target]
        return strategy


def _register_argmax_rule() -> None:
    """``aten.argmax`` on one mesh dimension: replicated, or split on a
    dimension it does not reduce: a split reduced dimension is gathered.
    DTensor's own handler (a local argmax, then a gathered one) is taken
    out: its reshape of the gathered candidates fails on the fake
    process group."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    DTensor._op_dispatcher._custom_op_handlers.pop(
        torch.ops.aten.argmax.default, None)

    @register_sharding(torch.ops.aten.argmax.default)
    def _argmax(x, dim=None, keepdim=False):
        rules = [([Replicate()], [Replicate(), None, None])]
        if dim is not None:
            dim %= x.ndim
            for d in range(x.ndim):
                if d != dim:
                    out = d if keepdim or d < dim else d - 1
                    rules.append(([Shard(out)], [Shard(d), None, None]))
        return rules


def fake_device(device="cuda") -> torch.device:
    """The device the fake tensors claim: ``device``, except ``cuda`` on a
    torch built without CUDA, which claims the CPU (see the module
    docstring)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.backends.cuda.is_built():
        return torch.device("cpu")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev


def compute_mesh(mesh):
    """The mesh the cell's DTensors live on: ``mesh`` itself, or for the
    multi-pod (pod, data, model) mesh its (pod·data, model) view, one
    dimension ``"pod_data"`` over the same ranks in the same order.  The
    rules split ``pod`` and ``data`` only together (the batch over
    ``("pod", "data")``), so every shard and every collective group is the
    same on the view; DTensor's redistribution planner, which searches
    over mesh dimensions, stays on two."""
    from torch.distributed.device_mesh import DeviceMesh

    if tuple(mesh.mesh_dim_names) != ("pod", "data", "model"):
        return mesh
    pod, data, model = mesh.shape
    return DeviceMesh(mesh.device_type, mesh.mesh.reshape(pod * data, model),
                      mesh_dim_names=("pod_data", "model"))


def _block(shape, placements, mesh):
    """This device's block of a tensor of ``shape`` placed by
    ``placements`` on ``mesh``: (offset, length) per tensor dimension, or
    None where a split is uneven."""
    coord = mesh.get_coordinate()
    out = []
    for d, size in enumerate(shape):
        index, count = 0, 1
        for j, p in enumerate(placements):
            if p.is_shard(d):
                index, count = index * mesh.size(j) + coord[j], \
                    count * mesh.size(j)
        if size % count:
            return None
        out.append((index * (size // count), size // count))
    return out


def _place(meta, sharding, mesh, device):
    """A DTensor of ``meta``'s shape and dtype, placed by ``sharding``,
    its local shard a fake tensor on ``device`` (call under the fake
    mode); a non-tensor leaf (the cache's host ``pos``) is returned as
    it is."""
    from torch.distributed.tensor import DTensor

    from repro_torch.core.packing import PackedText

    if isinstance(meta, PackedText):
        return dataclasses.replace(
            meta, words=_place(meta.words, sharding.words, mesh, device))
    if not isinstance(meta, torch.Tensor):
        return meta
    pl = shd.placements(sharding.spec, mesh)
    block = _block(meta.shape, pl, mesh)
    if block is None:
        raise ValueError(f"{tuple(meta.shape)} does not split evenly by {pl}")
    local = torch.empty([n for _, n in block], dtype=meta.dtype, device=device)
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=meta.shape,
                              stride=torch.empty(meta.shape,
                                                 device="meta").stride())


# One-card memory measures that cut a step into pieces: AdamW's leaf
# pieces, the SSM scan's row groups, MLA's rows of logits.  Each reckons
# from the shapes it sees, global ones on a DTensor, and a piece of a
# sharded dimension would make DTensor gather it; the traced step runs
# each whole, as JAX's per-device program does.
_PIECE_LIMITS = ((adamw, "UPDATE_CHUNK"), (ssm, "SCAN_BYTES"),
                 (nn, "MLA_LOGIT_BYTES"))


@contextlib.contextmanager
def _traced_model():
    """The model as the trace runs it: every piece whole, the six
    functions that DTensor would otherwise shard badly replaced by the
    same computations written for a split mesh (:func:`_split_sdpa`,
    :func:`_split_mla_attend`, :func:`_split_conv`,
    :func:`_split_mamba2_heads`, :func:`_lookup_embed`,
    :func:`_split_vocab_cross_entropy`), and
    DTensor's moves of a split as all-to-alls on every mesh
    (:func:`_shard_dim_alltoall`)."""
    swaps = [(mod, name, 1 << 62) for mod, name in _PIECE_LIMITS]
    from torch.distributed.tensor import placement_types

    swaps += [(placement_types, "shard_dim_alltoall", functools.partial(
                  _shard_dim_alltoall, placement_types.shard_dim_alltoall)),
              (nn, "_sdpa", functools.partial(_split_sdpa, nn._sdpa)),
              (nn, "_mla_attend", functools.partial(
                  _split_mla_attend, nn._mla_attend)),
              (ssm, "_causal_conv", functools.partial(
                  _split_conv, ssm._causal_conv)),
              (ssm, "_mamba2_heads", functools.partial(
                  _split_mamba2_heads, ssm._mamba2_heads)),
              (T, "_embed_tokens", _lookup_embed),
              (steps, "cross_entropy", _split_vocab_cross_entropy)]
    old = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, value in swaps:
        setattr(mod, name, value)
    try:
        yield
    finally:
        for (mod, name, _), value in zip(swaps, old):
            setattr(mod, name, value)


def _shard_dim_alltoall(original, x, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's move of a split from one dim to another (``original``),
    always as the all-to-all it is on a card: on a CPU mesh DTensor makes
    it an all-gather and a chunk (gloo has no all-to-all), which the fake
    process group does not need."""
    if mesh.device_type != "cpu":
        return original(x, gather_dim, shard_dim, mesh, mesh_dim)
    from torch.distributed import _functional_collectives as funcol

    group = funcol._resolve_group((mesh, mesh_dim))
    return torch.ops._dtensor.shard_dim_alltoall(
        x, gather_dim, shard_dim, funcol._group_or_group_name(group))


def _split_conv(conv, x, w, b):
    """``ssm._causal_conv`` (x (B, S, C), w (K, C), b (C,)) on DTensors,
    each device on its own rows and channels (``local_map``): a depthwise
    convolution needs no other device's data.  DTensor's own handler for
    ``aten.convolution`` runs the local op without first redistributing
    its inputs (it mixes a channel-split weight with whole inputs).  Per
    mesh dimension: channels split where the weight's are (x gathered on
    its rows there if need be), rows split where x's are (the weight and
    bias gradients partial there), else all replicated."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(x, DTensor):
        return conv(x, w, b)
    rep = Replicate()
    xs, ws, bs, grads = [], [], [], []
    for px, pw in zip(x.placements, w.placements):
        if pw == Shard(1):
            plan = Shard(2), Shard(1), Shard(0), (Shard(1), Shard(0))
        elif px == Shard(0):
            plan = Shard(0), rep, rep, (Partial(), Partial())
        else:
            plan = rep, rep, rep, (rep, rep)
        for out, p in zip((xs, ws, bs, grads), plan):
            out.append(p)
    mesh = x.device_mesh
    x, w, b = (t.redistribute(mesh, pl) for t, pl in ((x, xs), (w, ws),
                                                       (b, bs)))
    return local_map(conv, out_placements=xs, in_placements=(xs, ws, bs),
                     in_grad_placements=(xs, [g[0] for g in grads],
                                         [g[1] for g in grads]),
                     device_mesh=mesh)(x, w, b)


def _split_mamba2_heads(heads, xs, dt, a, b_in, c_out, h0, hd, return_state):
    """``ssm._mamba2_heads`` (xs (B, S, NH*HD), dt (B, S, NH), a (NH,),
    b_in / c_out (B, S, N), h0 (B, NH, HD, N) or None) on DTensors, each
    device on its own rows and channels (``local_map``), as XLA's
    per-device program runs mamba2.  DTensor's own views of the split
    channels as (NH, HD) fail where the heads do not divide the mesh
    dimension (zamba2's 2 SSM heads at smoke width on a 4-way ``model``
    axis), and torch 2.11's DTensor cannot flatten the two split dims of
    the read-out.  Two layouts, both even splits, with no padded head:

    * channels (a full sequence): xs's own split of its channels, each
      device on a contiguous block of them, run as sub-heads of the
      block's largest width that divides the head width and the block's
      offset (each channel's recurrence reads only its head's ``dt`` and
      ``a``), so any head count over any mesh dimension; the whole
      sequence stays on the device (the scan is not split on S);
    * the state's (decode, or a prefill state whose block is not whole
      heads): the cache's split of h0 on its heads or head channels (the
      cache splits HD first, as JAX's does), xs gathered to each device
      and sliced to the block, y gathered back to xs's placements (S is
      1 in decode).

    Rows split alike on every layout; ``dt``, ``a``, ``b_in`` and
    ``c_out`` are read whole (their gradients partial where a device
    reads part of them).  Any other placement goes to ``heads`` as it is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(xs, DTensor) or any(
            p not in (Shard(0), Shard(2), Replicate()) for p in xs.placements):
        return heads(xs, dt, a, b_in, c_out, h0, hd, return_state)
    mesh, rep = xs.device_mesh, Replicate()
    b, s, di = xs.shape
    nh, n = di // hd, b_in.shape[-1]
    chan = _block(xs.shape, xs.placements, mesh)
    if chan is None:
        return heads(xs, dt, a, b_in, c_out, h0, hd, return_state)
    if h0 is None and not (return_state and chan[2][1] % hd):
        return _channel_heads(heads, xs, dt, a, b_in, c_out, hd,
                              return_state, chan[2])
    if h0 is not None:
        hp = list(h0.placements)
    else:
        hp = [{Shard(0): Shard(0), Shard(2): Shard(2)}.get(p, rep)
              for p in xs.placements]
    block = _block((b, nh, hd, n), hp, mesh)
    if (block is None or Shard(3) in hp
            or any((p == Shard(0)) != (q == Shard(0))
                   for p, q in zip(xs.placements, hp))):
        return heads(xs, dt, a, b_in, c_out, h0, hd, return_state)
    (h_lo, h_len), (d_lo, d_len) = block[1], block[2]
    rows = [Shard(0) if p == Shard(0) else rep for p in hp]
    part = [Shard(0) if p == Shard(0) else (rep if p == rep else Partial())
            for p in hp]
    whole = [Partial() if p != rep else rep for p in hp]
    y4 = [{Shard(1): Shard(2), Shard(2): Shard(3)}.get(p, p) for p in hp]

    def local(x, t, al, bi, co, *h):
        x = x.reshape(*x.shape[:2], nh, hd)[:, :, h_lo:h_lo + h_len,
                                            d_lo:d_lo + d_len]
        y, new_h = heads(x.reshape(*x.shape[:2], h_len * d_len),
                         t[..., h_lo:h_lo + h_len], al[h_lo:h_lo + h_len],
                         bi, co, h[0] if h else None, d_len, True)
        return y.reshape(*y.shape[:2], h_len, d_len), new_h

    args = (xs, dt, a, b_in, c_out) + (() if h0 is None else (h0,))
    pls = (rows, rows, [rep] * mesh.ndim, rows, rows, hp)[:len(args)]
    grads = (part, part, whole, part, part, hp)[:len(args)]
    y, new_h = local_map(local, out_placements=(y4, hp), in_placements=pls,
                         in_grad_placements=grads, device_mesh=mesh)(
        *(t.redistribute(mesh, pl) for t, pl in zip(args, pls)))
    y = y.redistribute(mesh, rows).reshape(b, s, di)
    return y.redistribute(mesh, xs.placements), new_h


def _channel_heads(heads, xs, dt, a, b_in, c_out, hd, return_state, chan):
    """:func:`_split_mamba2_heads` on xs's split of its channels: this
    device's block ``chan`` = (offset, length) of them as sub-heads of
    width ``g``, each reading its own head's ``dt`` and ``a``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, rep = xs.device_mesh, Replicate()
    lo, c = chan
    g = math.gcd(hd, lo, c)
    xp = list(xs.placements)
    rows = [Shard(0) if p == Shard(0) else rep for p in xp]
    part = [Partial() if p == Shard(2) else q for p, q in zip(xp, rows)]
    whole = [rep if p == rep else Partial() for p in xp]
    state = [{Shard(2): Shard(1)}.get(p, p) for p in xp]

    def local(x, t, al, bi, co):
        idx = torch.arange(lo, lo + c, g, device=x.device) // hd
        y, new_h = heads(x, t.index_select(-1, idx), al.index_select(0, idx),
                         bi, co, None, g, return_state)
        return (y, new_h) if return_state else y

    pls = (xp, rows, [rep] * mesh.ndim, rows, rows)
    out = local_map(local, out_placements=(xp, state) if return_state else xp,
                    in_placements=pls,
                    in_grad_placements=(xp, part, whole, part, part),
                    device_mesh=mesh)(
        *(t.redistribute(mesh, pl) for t, pl in
          zip((xs, dt, a, b_in, c_out), pls)))
    return out if return_state else (out, None)


def _lookup_embed(params, tokens, cfg, dtype):
    """``transformer._embed_tokens`` as ``F.embedding``, the same row
    lookup: on a vocab-split table DTensor masks each device's rows and
    all-reduces them, as XLA's per-device program does (DTensor's rule for
    the indexing in ``_embed_tokens`` moves the whole table to a split of
    its rows' width instead)."""
    scale = torch.tensor(math.sqrt(cfg.d_model), dtype=dtype,
                         device=tokens.device)
    return torch.nn.functional.embedding(
        tokens.to(torch.int64), params["embed"]).to(dtype) * scale


def _split_vocab_cross_entropy(logits, labels):
    """``steps.cross_entropy`` on DTensor logits, as XLA's per-device
    program computes it: over a split vocab the log-sum-exp as a max and
    a sum of exponentials, each reduced across the devices that split it,
    and the label's logit picked by a mask of the device's own classes and
    summed.  The same value; autograd's backward of ``gather`` makes its
    zeros with ``new_zeros`` at the logits' global shape, which DTensor
    replicates on every device."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    last = logits.dim() - 1
    mesh = logits.device_mesh
    logits = logits.to(torch.float32)
    if any(p.is_shard(last) for p in logits.placements):
        top = logits.amax(dim=-1, keepdim=True).detach()
        logz = (torch.log(torch.sum(torch.exp(logits - top), dim=-1))
                + top[..., 0])
    else:
        logz = torch.logsumexp(logits, dim=-1)
    ids = DTensor.from_local(
        torch.arange(logits.shape[-1], device=logits.device), mesh,
        [Replicate()] * mesh.ndim, run_check=False).redistribute(
        mesh, [Shard(0) if p.is_shard(last) else Replicate()
               for p in logits.placements])
    hit = ids == labels[..., None].to(torch.int64)
    ll = torch.sum(torch.where(hit, logits, 0.0), dim=-1)
    return torch.mean(logz - ll)


def _split_sdpa(sdpa, q, k, v, mask, *, kv_groups: int):
    """``nn._sdpa`` (q (B, Sq, H, D), k / v (B, Sk, KV, D)) on DTensors,
    each device on its own rows and heads (``local_map``), as XLA's
    per-device program runs attention.  DTensor's own einsums would view
    heads split over a mesh dimension as (KV, groups), which fails where
    the dimension divides the query heads but not the KV heads
    (qwen3-1.7b: 16 and 8 on the 16-way ``model`` axis), and flatten two
    split dimensions, which torch 2.11's DTensor cannot.  Per mesh
    dimension:

    * rows split (q on dim 0): k, v and a batched mask split alike;
    * queries split on their sequence (the ``sp`` variant): k and v
      gathered, the mask split on its query dim;
    * heads split, or splittable (a replicated q is sliced: its gradient
      arrives split so, from the output projection): k and v split on
      their heads where the KV heads divide too; else gathered whole, and
      each device reads the one KV head its query heads read;
    * all replicated: each device computes all of it.

    A k or v gradient that the devices of a dimension each hold in part
    (a gathered k) is partial there.  Against a cache split on its head
    dim (``cache_shardings``' fallback where the KV heads do not divide)
    the queries are split on their head dim too, DTensor runs ``sdpa``
    (the logits' partial sums reduced), and the output goes back to a
    split of the heads, or a replica, for the output projection.  Any
    other placement goes to ``sdpa`` as it is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(q, DTensor) or k.placements != v.placements:
        return sdpa(q, k, v, mask, kv_groups=kv_groups)
    mesh, rep = q.device_mesh, Replicate()
    h, kvh = q.shape[2], k.shape[2]
    if Shard(3) in k.placements:
        return _head_dim_sdpa(sdpa, q, k, v, mask, kv_groups)
    if not isinstance(mask, DTensor):
        mask = DTensor.from_local(mask, mesh, [rep] * mesh.ndim,
                                  run_check=False)
    qs, ks, ms, grads, sliced = [], [], [], [], None
    for j, (pq, pk) in enumerate(zip(q.placements, k.placements)):
        n = mesh.size(j)
        if pq == Shard(0) and pk == Shard(0):
            rows = mask.shape[0] == q.shape[0]
            plan = Shard(0), Shard(0), Shard(0) if rows else rep, Shard(0)
        elif pq == Shard(1) and pk in (rep, Shard(1)):
            plan = Shard(1), rep, Shard(mask.dim() - 2), Partial()
        elif (n > 1 and h % n == 0 and pq in (rep, Shard(2))
              and pk in (rep, Shard(2))):
            if kvh % n == 0:
                plan = Shard(2), Shard(2), rep, Shard(2)
            elif sliced is None and kv_groups % (h // n) == 0:
                plan, sliced = (Shard(2), rep, rep, Partial()), j
            else:
                return sdpa(q, k, v, mask, kv_groups=kv_groups)
        elif pq == rep and pk == rep:
            plan = rep, rep, rep, rep
        else:
            return sdpa(q, k, v, mask, kv_groups=kv_groups)
        for out, p in zip((qs, ks, ms, grads), plan):
            out.append(p)
    q, k, v = (t.redistribute(mesh, pl) for t, pl in ((q, qs), (k, ks),
                                                       (v, ks)))
    mask = mask.redistribute(mesh, ms)

    def local(ql, kl, vl, ml):
        if sliced is None:
            return sdpa(ql, kl, vl, ml, kv_groups=kv_groups)
        per_device = ql.shape[2]  # query heads, all reading one KV head
        first = mesh.get_local_rank(sliced) * per_device // kv_groups
        one = slice(first, first + 1)
        return sdpa(ql, kl[:, :, one], vl[:, :, one], ml,
                    kv_groups=per_device)

    return local_map(local, out_placements=qs,
                     in_placements=(qs, ks, ks, ms),
                     in_grad_placements=(qs, grads, grads, ms),
                     device_mesh=mesh)(q, k, v, mask)


def _split_mla_attend(attend, p, q_nope, q_rope, c_kv, k_rope, mask, scale):
    """``nn._mla_attend`` (queries (B, Sq, H, ·), latents (B, Sk, ·), the
    up-projections ``w_uk`` / ``w_uv`` (L, H, hd)) on DTensors, each device
    on its own rows and heads (``local_map``), as :func:`_split_sdpa`:
    rows split alike; heads split (or splittable) with the up-projections,
    the latents gathered (their gradient partial there); or all
    replicated.  Any other placement goes to ``attend`` as it is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(q_nope, DTensor):
        return attend(p, q_nope, q_rope, c_kv, k_rope, mask, scale)
    mesh, rep, h = q_nope.device_mesh, Replicate(), q_nope.shape[2]
    if not isinstance(mask, DTensor):
        mask = DTensor.from_local(mask, mesh, [rep] * mesh.ndim,
                                  run_check=False)
    w_uk, w_uv = p["w_uk"], p["w_uv"]
    qs, ls, ms, ws, grads = [], [], [], [], []
    for j, (pq, pl, pw) in enumerate(zip(q_nope.placements, c_kv.placements,
                                         w_uk.placements)):
        n = mesh.size(j)
        if pq == Shard(0) and pl == Shard(0) and pw == rep:
            plan = (Shard(0), Shard(0),
                    Shard(0) if mask.shape[0] == q_nope.shape[0] else rep,
                    rep, Shard(0))
        elif (n > 1 and h % n == 0 and pq in (rep, Shard(2))
              and pw in (rep, Shard(1))):
            plan = Shard(2), rep, rep, Shard(1), Partial()
        elif pq == rep and pw == rep:
            plan = rep, rep, rep, rep, rep
        else:
            return attend(p, q_nope, q_rope, c_kv, k_rope, mask, scale)
        for out, pl_ in zip((qs, ls, ms, ws, grads), plan):
            out.append(pl_)
    q_nope, q_rope = (t.redistribute(mesh, qs) for t in (q_nope, q_rope))
    c_kv, k_rope = (t.redistribute(mesh, ls) for t in (c_kv, k_rope))
    w_uk, w_uv = (t.redistribute(mesh, ws) for t in (w_uk, w_uv))
    mask = mask.redistribute(mesh, ms)
    wgrads = [Shard(1) if w == Shard(1) else (Partial() if g == Shard(0)
                                              else rep)
              for w, g in zip(ws, grads)]

    def local(qn, qr, ckv, kr, m, uk, uv):
        return attend({"w_uk": uk, "w_uv": uv}, qn, qr, ckv, kr, m, scale)

    return local_map(local, out_placements=qs,
                     in_placements=(qs, qs, ls, ls, ms, ws, ws),
                     in_grad_placements=(qs, qs, grads, grads, ms, wgrads,
                                         wgrads),
                     device_mesh=mesh)(q_nope, q_rope, c_kv, k_rope, mask,
                                       w_uk, w_uv)


def _head_dim_sdpa(sdpa, q, k, v, mask, kv_groups: int):
    """:func:`_split_sdpa` against a cache split on its head dim."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, h = q.device_mesh, q.shape[2]
    split = [Shard(3) if pk == Shard(3) else pq
             for pq, pk in zip(q.placements, k.placements)]
    back = [(Shard(2) if h % mesh.size(j) == 0 else Replicate())
            if pk == Shard(3) else pq
            for j, (pq, pk) in enumerate(zip(q.placements, k.placements))]
    out = sdpa(q.redistribute(mesh, split), k, v, mask, kv_groups=kv_groups)
    return out.redistribute(mesh, back)


def trace_cell(fn, args, in_sh, mesh, device, *, act_spec=None):
    """Run ``fn`` once on fake DTensors of ``args`` placed by ``in_sh`` and
    return (DeviceCounts, memory dict, seconds)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.core.packing import PackedText

    _register_rules()
    cmesh = compute_mesh(mesh)
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        placed = tuple(pytree.tree_map(
            lambda m, s: _place(m, s, cmesh, device), a, sh)
            for a, sh in zip(args, in_sh))
    t0 = time.perf_counter()
    counter = DeviceCounter(fake, arguments=[
        x.words if isinstance(x, PackedText) else x
        for x in pytree.leaves(placed)])
    with (implicit_replication(), _traced_model(),
          T.activation_sharding(act_spec), counter):
        out = fn(*placed)
        mem = counter.memory(out)
    return counter.counts, mem, time.perf_counter() - t0


def _sp_spec(mesh):
    return (shd.dp_axes(mesh), "model", None)


def _cell_counts(cfg, shape, mesh, remat_policy: str, variant: str, device):
    fn, args, in_sh, _, _ = build_cell(cfg, shape, mesh,
                                       remat_policy=remat_policy,
                                       variant=variant)
    return trace_cell(fn, args, in_sh, mesh, device,
                      act_spec=_sp_spec(mesh) if variant == "sp" else None)


# ---------------------------------------------------------------------------
# Depth: every layer is traced, so the counts are the full-depth counts.
# The linear fit of JAX's ``extrapolated_costs`` is kept to check that the
# counts are linear in depth: Q(L) = b + a·L from two reduced depths.
# ---------------------------------------------------------------------------

def _depth_points(cfg) -> tuple[int, int]:
    if cfg.family == "hybrid":
        return cfg.attn_every, 2 * cfg.attn_every
    if cfg.family == "encdec":
        return 4, 8  # 2enc+2dec, 4enc+4dec
    if cfg.family == "moe" and cfg.n_dense_layers:
        return cfg.n_dense_layers + 2, cfg.n_dense_layers + 4
    return 2, 4


def _with_depth(cfg, depth: int):
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, n_layers=depth,
                                   n_enc_layers=depth // 2,
                                   n_dec_layers=depth // 2)
    return dataclasses.replace(cfg, n_layers=depth)


def _cell_costs(cfg, shape, mesh, remat_policy: str, variant: str = "base",
                device="cpu"):
    """(flops, hbm_bytes, wire_bytes) per device for one traced cell."""
    counts, _, _ = _cell_counts(cfg, shape, mesh, remat_policy, variant,
                                device)
    coll = roofline.collective_stats(counts.collectives)
    return float(counts.flops), float(counts.hbm_bytes), float(coll.wire_bytes)


def extrapolated_costs(cfg, shape, mesh, remat_policy: str,
                       variant: str = "base", device="cpu"):
    l1, l2 = _depth_points(cfg)
    q1 = _cell_costs(_with_depth(cfg, l1), shape, mesh, remat_policy,
                     variant, device)
    q2 = _cell_costs(_with_depth(cfg, l2), shape, mesh, remat_policy,
                     variant, device)
    lf = cfg.n_layers
    out = []
    for a, b in zip(q1, q2):
        slope = (b - a) / (l2 - l1)
        out.append(max(0.0, a + slope * (lf - l1)))
    return tuple(out)  # (flops, hbm_bytes, wire_bytes) at full depth


# ---------------------------------------------------------------------------
# ERA engine dry-run cell: the paper's own workload on the production mesh.
# One elastic-range SubTreePrepare iteration over a batch of virtual trees,
# one per device, groups sharded over every mesh axis (ERA has no matmul to
# TP-shard: every device is an independent worker — §5).  The string is
# replicated (the shared-nothing broadcast).  Zero collectives in the step
# is the paper's no-merge parallelism.
# ---------------------------------------------------------------------------

ERA_GENOME_N = 2_100_000_000  # human-genome scale, int32-offset safe
ERA_F_M = 1 << 20             # leaves per virtual tree (MTS 32MB @ 32B/node)
ERA_RANGE_W = 64


def build_era_cell(mesh, *, w: int = ERA_RANGE_W, n: int = ERA_GENOME_N,
                   f_m: int = ERA_F_M, packed: bool = False):
    """(fn, args_abstract, in_shardings, out_shardings, donate) of one
    elastic-range step: the text as ``meta`` (a :class:`PackedText` of
    ``n // 16`` 2-bit words, or the ``n``-byte string) and a ``(G, F)``
    :class:`PrepareState`, G the mesh's size."""
    from repro_torch.core.packing import PackedText
    from repro_torch.core.prepare import PrepareState
    from repro_torch.launch.era_run import era_prepare_batch

    g = math.prod(shd.axis_sizes(mesh).values())  # one virtual tree a device
    all_axes = tuple(shd.axis_sizes(mesh))
    rep = shd.replicated(mesh)
    if packed:
        # dense 2-bit DNA storage: 16 symbols / 32-bit word — the
        # replicated string costs n/4 bytes of device memory, not n.  The
        # reads of w symbols past the last real one stay in the words.
        n_words = n // 16
        s_abs = PackedText(
            words=torch.empty((n_words,), dtype=torch.int32, device="meta"),
            n_real=16 * (n_words - 1) - w, bits=2, terminal=4)
        s_shard = PackedText(words=rep, n_real=None, bits=None, terminal=None)
    else:
        s_abs = torch.empty((n,), dtype=torch.uint8, device="meta")
        s_shard = rep
    field = lambda: torch.empty((g, f_m), dtype=torch.int32, device="meta")
    st_abs = PrepareState(*(field() for _ in PrepareState._fields))
    by_group = shd.NamedSharding(mesh, (all_axes, None))
    st_shard = PrepareState(*([by_group] * 6))

    def local_step(text, *fields):
        """One device's program: its own groups over the whole text."""
        s = dataclasses.replace(s_abs, words=text) if packed else text
        new, n_active = era_prepare_batch(s, PrepareState(*fields), w=w)
        return (*new, n_active)

    def fn(s_padded, states):
        """The step with every group on its own device: the rows are
        independent, so each device runs :func:`local_step` on its shards
        (``local_map``), as XLA's per-device program does; no
        collective."""
        from torch.distributed.tensor.experimental import local_map

        text = s_padded.words if packed else s_padded
        on = text.device_mesh  # the mesh the DTensors live on
        rep = shd.placements((), on)
        rows = shd.placements((all_axes, None), on)
        step = local_map(local_step, out_placements=(rows,) * 7,
                         in_placements=(rep,) + (rows,) * 6)
        *new, n_active = step(text, *states)
        return PrepareState(*new), n_active

    args = (s_abs, st_abs)
    in_sh = (s_shard, st_shard)
    out_sh = (st_shard, shd.NamedSharding(mesh, (all_axes,)))
    return fn, args, in_sh, out_sh, (1,)


def _memory_record(mem: dict) -> dict:
    return {k: int(v) for k, v in mem.items()}


def _collectives_record(coll) -> dict:
    return {"counts": coll.count_by_kind,
            "result_bytes": coll.bytes_by_kind,
            "wire_bytes_per_device": coll.wire_bytes,
            "wire_bytes_network_per_device": coll.network_wire_bytes}


def run_era_cell(multi_pod: bool, *, packed: bool = False,
                 device="cuda") -> dict:
    dev = fake_device(device)
    rec = {"arch": "era-genome" + ("-packed" if packed else ""),
           "shape": "prepare_2.1G", "mesh": "2x16x16" if multi_pod else "16x16",
           "remat_policy": "n/a", "variant": "base", "device": dev.type}
    t0 = time.perf_counter()
    try:
        with mesh_lib.fake_world(512 if multi_pod else 256):
            mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                                 device=dev)
            fn, args, in_sh, _, _ = build_era_cell(mesh, packed=packed)
            counts, mem, t_trace = trace_cell(fn, args, in_sh, mesh, dev)
            # single iteration; no layers -> the counts are exact
            terms, coll = roofline.terms_from_counts(counts, mesh.size(), 0.0)
        rec.update(
            status="ok", t_trace_s=round(t_trace, 2),
            memory=_memory_record(mem), roofline=terms.to_dict(),
            collectives=_collectives_record(coll),
            **_counts_record(counts))
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    rec["t_total_s"] = round(time.perf_counter() - t0, 2)
    return rec


def _counts_record(counts) -> dict:
    """The hand kernels traced, by name."""
    return {"kernels": _kernel_ops(counts)}


def _kernel_ops(counts) -> dict:
    """How many times each hand kernel's custom op was traced."""
    return {k.split(".", 1)[1]: v for k, v in sorted(counts.ops.items())
            if k.startswith("repro_torch.")}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             remat_policy: str = "none", variant: str = "base",
             device="cuda") -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_is_runnable(cfg, shape)
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "remat_policy": remat_policy,
        "variant": variant,
    }
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    dev = fake_device(device)
    rec["device"] = dev.type
    t0 = time.perf_counter()
    try:
        with mesh_lib.fake_world(512 if multi_pod else 256):
            mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                                 device=dev)
            counts, mem, t_trace = _cell_counts(cfg, shape, mesh,
                                                remat_policy, variant, dev)
            terms, coll = roofline.terms_from_counts(
                counts, mesh.size(), model_flops(cfg, shape))
        rec.update(
            status="ok",
            t_trace_s=round(t_trace, 2),
            memory=_memory_record(mem),
            roofline=terms.to_dict(),
            collectives=_collectives_record(coll),
            **_counts_record(counts),
        )
    except Exception as e:  # a failing cell is a bug to fix, but keep going
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    rec["t_total_s"] = round(time.perf_counter() - t0, 2)
    return rec


def _key(r) -> tuple:
    return (r["arch"], r["shape"], r["mesh"], r.get("remat_policy", "none"),
            r.get("variant", "base"))


def _store(results: list, rec: dict, path: str) -> list:
    results = [r for r in results if _key(r) != _key(rec)]
    results.append(rec)
    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", choices=["off", "on", "both"], default="both")
    ap.add_argument("--out", default="experiments/dryrun_torch.json")
    ap.add_argument("--remat-policy", default="none")
    ap.add_argument("--variant", default="base",
                    choices=["base", "sp", "seqcache"])
    ap.add_argument("--device", default="cuda",
                    help="the device the fake tensors claim: cuda (default; "
                         "no card needed) or cpu")
    args = ap.parse_args(argv)

    era_only = args.arch in ("era", "era-packed")
    archs = list(ARCHS) if args.arch == "all" else ([] if era_only else [args.arch])
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    pods = {"off": [False], "on": [True], "both": [False, True]}[args.multi_pod]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {_key(r) for r in results if r.get("status") in ("ok", "skipped")}

    for arch in archs:
        for shape_name in shapes:
            for mp in pods:
                mesh_name = "2x16x16" if mp else "16x16"
                key = (arch, shape_name, mesh_name, args.remat_policy, args.variant)
                if key in done:
                    print(f"[cached] {key}")
                    continue
                print(f"[dryrun] {arch} × {shape_name} × {mesh_name} "
                      f"variant={args.variant} ...", flush=True)
                rec = run_cell(arch, shape_name, mp, args.remat_policy,
                               args.variant, args.device)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (f" bottleneck={r['bottleneck']}"
                             f" tc={r['t_compute_s']:.3g}s tm={r['t_memory_s']:.3g}s"
                             f" tx={r['t_collective_s']:.3g}s"
                             f" useful={r['useful_flops_ratio']:.2f}"
                             f" trace={rec['t_trace_s']}s")
                elif status == "error":
                    extra = " " + rec["error"][:200]
                print(f"  -> {status}{extra}", flush=True)
                results = _store(results, rec, args.out)

    # ERA engine cells (paper-representative; included in 'all' sweeps)
    if args.arch in ("all", "era", "era-packed"):
        packed_opts = {"all": [False, True], "era": [False],
                       "era-packed": [True]}[args.arch]
        for packed in packed_opts:
            for mp in pods:
                name = "era-genome" + ("-packed" if packed else "")
                mesh_name = "2x16x16" if mp else "16x16"
                key = (name, "prepare_2.1G", mesh_name, "n/a", "base")
                if key in done:
                    print(f"[cached] {key}")
                    continue
                print(f"[dryrun] {name} × prepare_2.1G × {mesh_name} ...", flush=True)
                rec = run_era_cell(mp, packed=packed, device=args.device)
                if rec["status"] == "ok":
                    r = rec["roofline"]
                    print(f"  -> ok bottleneck={r['bottleneck']}"
                          f" tc={r['t_compute_s']:.3g}s tm={r['t_memory_s']:.3g}s"
                          f" tx={r['t_collective_s']:.3g}s", flush=True)
                else:
                    print(f"  -> {rec['status']} {rec.get('error', '')[:200]}", flush=True)
                results = _store(results, rec, args.out)

    n_ok = sum(1 for r in results if r["status"] == "ok")
    n_skip = sum(1 for r in results if r["status"] == "skipped")
    n_err = sum(1 for r in results if r["status"] == "error")
    print(f"\ndry-run complete: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    if n_err:
        for r in results:
            if r["status"] == "error":
                print(f"  ERROR {r['arch']} × {r['shape']} × {r['mesh']}: {r['error'][:200]}")


if __name__ == "__main__":
    main()

"""Logical-axis → mesh sharding rules (DP / TP / EP / SP) — the port of
``repro.sharding``.

Every parameter Spec carries logical axis names (see ``models/nn.py``);
this module maps them onto the mesh, with the JAX package's rule table:

* ``vocab / heads / kv_heads / mlp / experts / inner`` → the ``model`` axis
  (TP for dense projections, EP for expert stacks, vocab-parallel embeddings)
* batch dims of activations/caches → the data axes ``("pod", "data")``
* long-context decode (batch=1) → KV-cache *sequence* dim over ``data`` (SP)

A logical axis is only sharded when its size divides the mesh axis size,
so one table serves all ten architectures.

A spec is JAX's ``PartitionSpec`` vocabulary as a tuple with one entry
per tensor dimension: a mesh axis name, a tuple of names (a dimension
split over several axes, major first), or None (replicated).  A
:class:`NamedSharding` pairs it with its mesh, and :func:`placements`
turns it into DTensor placements.  ``mesh`` is a
:class:`torch.distributed.device_mesh.DeviceMesh` with named dimensions
(:mod:`repro_torch.launch.mesh`), or any object with JAX's ``axis_names``
and a ``shape`` mapping from name to size (the rules read nothing else).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

from repro_torch import pytree

# logical axis -> preferred mesh axis (first match that divides wins)
LOGICAL_RULES: dict[str | None, tuple[str, ...]] = {
    "vocab": ("model",),
    "embed": (),          # replicated: rows of weight matrices
    "heads": ("model",),
    "kv_heads": ("model",),
    "head": (),
    "mlp": ("model",),
    "experts": ("model",),
    "kv_lora": (),
    "inner": ("model",),
    "layers": (),         # the stacked layer dim
    None: (),
}


class NamedSharding(NamedTuple):
    """A spec on its mesh (``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: tuple


def _spec(parts) -> tuple:
    """``PartitionSpec(*parts)`` as a tuple: a one-axis tuple becomes the
    axis name, as JAX normalises it."""
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p
                 for p in parts)


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh or of a JAX-style mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def _mesh_axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 0)


def spec_for(shape: tuple, axes: tuple, mesh) -> tuple:
    parts = []
    used: set[str] = set()  # a mesh axis may appear at most once per spec
    for dim, ax in zip(shape, axes):
        chosen = None
        for cand in LOGICAL_RULES.get(ax, ()):
            sz = _mesh_axis_size(mesh, cand)
            if sz and dim % sz == 0 and cand not in used:
                chosen = cand
                used.add(cand)
                break
        parts.append(chosen)
    return tuple(parts)


def param_shardings(specs_tree, mesh):
    """Spec tree -> NamedSharding tree (same structure as params)."""
    from repro_torch.models.nn import map_specs

    return map_specs(
        lambda s: NamedSharding(mesh, spec_for(s.shape, s.axes, mesh)),
        specs_tree)


def dp_axes(mesh) -> tuple[str, ...]:
    names = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in dp_axes(mesh))


def batch_sharding(mesh, batch_size: int, ndim: int) -> NamedSharding:
    """Shard the leading batch dim over the data axes (DP)."""
    dp = dp_axes(mesh)
    total = _dp_size(mesh) if dp else 1
    lead = dp if total and batch_size % total == 0 else ()
    return NamedSharding(mesh, _spec((lead if lead else None,)
                                     + (None,) * (ndim - 1)))


def batch_shardings(mesh, batch_tree):
    """Sharding tree for an input batch (a dict of tensors or meta
    tensors: only their shapes are read)."""
    return pytree.tree_map(
        lambda x: batch_sharding(mesh, x.shape[0], len(x.shape)), batch_tree)


def cache_shardings(cfg, mesh, cache_tree, *, seq_parallel: bool = False):
    """Shardings for a decode cache.

    Layout conventions (see transformer.init_cache):
      attention KV   (L, B, S, KV, hd)   -> B→data, KV→model (if divisible)
      MLA latents    (L, B, S, lora)     -> B→data
      ssm conv state (L, B, K-1, di)     -> B→data, di→model
      ssm h state    (L, B, …, N)        -> B→data, inner/heads→model
      enc memory     (B, T, d)           -> B→data

    ``seq_parallel=True`` (long_500k, batch=1): the cache *sequence* dim is
    sharded over ``data`` instead (context/sequence parallelism).  The
    cache's host position ``pos`` (an int, JAX's scalar) is replicated.
    """
    dp = dp_axes(mesh)
    model_sz = _mesh_axis_size(mesh, "model")
    dp_sz = _dp_size(mesh) if dp else 1

    def one(x):
        shp = tuple(getattr(x, "shape", ()))
        if len(shp) == 0:  # pos scalar
            return NamedSharding(mesh, ())
        if len(shp) == 3 and shp[-1] == cfg.d_model:  # enc memory (B,T,d)
            b_ax = dp if shp[0] % max(dp_sz, 1) == 0 and dp_sz > 1 else None
            return NamedSharding(mesh, _spec((b_ax, None, None)))
        parts: list = [None] * len(shp)
        # dim 1 is batch for stacked (L, B, ...) caches
        if len(shp) >= 2:
            if shp[1] % max(dp_sz, 1) == 0 and dp_sz > 1 and not seq_parallel:
                parts[1] = dp
            elif seq_parallel and len(shp) >= 3 and shp[2] % max(dp_sz, 1) == 0:
                parts[2] = dp  # sequence dim of (L,B,S,…) caches
        # last-but-one dim: KV heads / ssm channels; last dim: head/state
        if len(shp) >= 4 and model_sz:
            if shp[-2] % model_sz == 0:
                parts[-2] = "model"
            elif shp[-1] % model_sz == 0:
                parts[-1] = "model"
        elif len(shp) == 3 and model_sz and shp[-1] % model_sz == 0:
            parts[-1] = "model"  # (L, B, lora) etc.
        return NamedSharding(mesh, _spec(parts))

    return {k: one(v) for k, v in cache_tree.items()}


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def placements(spec: tuple, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dimension:
    ``Shard(d)`` on every mesh dimension that tensor dimension ``d`` is
    split over, ``Replicate()`` on the others.  A dimension over several
    axes (``("pod", "data")``) is split major first, JAX's order, which is
    DTensor's for shards listed in mesh order; a spec naming them in
    another order raises.  On a flattened view of a mesh (a dimension
    named ``"pod_data"`` standing for ``pod`` and ``data`` together, see
    :func:`repro_torch.launch.dryrun.compute_mesh`) the axes it joins map
    to it.  An axis of size 1 is ``Replicate()``: it splits
    nothing, and DTensor would carry it through reshapes as a strided
    shard that several of its rules refuse."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = axis_sizes(mesh)
    names = list(sizes)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = _mesh_dims(axes, names)
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} are not in the "
                             f"mesh's major-to-minor order {names}")
        for i in idx:
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return out


def _mesh_dims(axes: tuple, names: list) -> list[int]:
    """Mesh dimensions of the axes of one spec entry, a run of axes that a
    flattened dimension joins (``"pod_data"``) taking that dimension."""
    idx, i = [], 0
    while i < len(axes):
        for j in range(len(axes), i, -1):
            name = "_".join(axes[i:j])
            if name in names:
                idx.append(names.index(name))
                i = j
                break
        else:
            raise ValueError(f"mesh axis {axes[i]!r} is not one of {names}")
    return idx

"""Gradient compression for the data-parallel all-reduce, with error
feedback (the port of ``repro.optim.compress``).

Per-tensor symmetric int8: each worker quantizes its local gradient, the
all-reduce averages the dequantized payloads, and what quantization
dropped is carried into the next step.  ``torch.round`` rounds half to
even as ``jnp.round`` does, so ``q`` and ``scale`` equal the JAX
package's.  :func:`psum_compressed` averages across a
``torch.distributed`` process group where JAX takes a ``pmean`` over a
``shard_map`` axis.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch import pytree


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8; returns (q, scale)."""
    xf = x.to(torch.float32)
    amax = torch.max(torch.abs(xf))
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_state(params: Any) -> Any:
    return pytree.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)


def compress_with_feedback(grads: Any, err: Any):
    """Returns ((q_tree, scale_tree), new_err).

    The caller all-reduces ``q`` (mean of dequantized values) across the
    data-parallel group; ``new_err`` holds what quantization dropped, added
    back next step.
    """
    q_leaves, s_leaves, ne_leaves = [], [], []
    for g, e in zip(pytree.leaves(grads), pytree.leaves(err)):
        target = g.to(torch.float32) + e
        q, scale = quantize_int8(target)
        q_leaves.append(q)
        s_leaves.append(scale)
        ne_leaves.append(target - dequantize_int8(q, scale))
    return ((pytree.unflatten_like(grads, q_leaves),
             pytree.unflatten_like(grads, s_leaves)),
            pytree.unflatten_like(grads, ne_leaves))


def decompress(qs: Any, scales: Any) -> Any:
    return pytree.tree_map(dequantize_int8, qs, scales)


def psum_compressed(grads: Any, err: Any, group=None):
    """Compressed data-parallel mean with error feedback: each rank's
    dequantized gradients averaged over ``group`` (the default group when
    None).  Without an initialized process group this is the mean over a
    world of one: the dequantized gradients themselves."""
    (qs, scales), new_err = compress_with_feedback(grads, err)
    deq = decompress(qs, scales)
    if not (dist.is_available() and dist.is_initialized()):
        return deq, new_err
    world = dist.get_world_size(group)

    def pmean(x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x / world

    return pytree.tree_map(pmean, deq), new_err

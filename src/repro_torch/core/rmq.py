"""Sparse-table range minimum (O(1) query) — PyTorch port of ``repro.core.rmq``.

The parallel Cartesian-tree builder (:mod:`repro_torch.core.build`)
computes all-nearest-smaller-values with it, and the analytics engine
(:mod:`repro_torch.core.analytics`) answers LCP-interval queries and
expands maximal repeats over the global LCP array.

Layout: where the JAX package keeps ``L + 1`` level arrays in a list and
stacks them on every query, the port stacks them ONCE:
``sparse_table(h, L)`` returns ``vals`` of shape ``(L + 1, *h.shape)``
with ``vals[k, ..., i] = min(h[..., i : i + 2**k])`` (clipped to the end
of the last dimension) and, on request, ``args`` of the same shape with
the LEFTMOST index attaining it.  Tables run along the last dimension, so
a ``(P, F)`` batch of rows builds and queries as one tensor.  Queries are
closed intervals ``[lo, hi]`` whose leading dimensions match the table's.
"""

from __future__ import annotations

import numpy as np
import torch

_BIG = torch.iinfo(torch.int32).max


def log2_ceil(x: int) -> int:
    return max(1, int(np.ceil(np.log2(max(2, x)))))


def sparse_table(h: torch.Tensor, n_levels: int, *, with_args: bool = False):
    """Leftmost-argmin sparse table over the last dimension of int32 ``h``.

    Returns ``(vals, args)``: ``(n_levels + 1, *h.shape)`` int32 tensors
    (``args`` is None unless ``with_args``)."""
    n = h.shape[-1]
    vals = torch.empty((n_levels + 1, *h.shape), dtype=torch.int32,
                       device=h.device)
    vals[0] = h
    args = None
    if with_args:
        args = torch.empty_like(vals)
        args[0] = torch.arange(n, dtype=torch.int32, device=h.device)
    span = 1
    for k in range(n_levels):
        prev = vals[k]
        shifted = torch.full_like(prev, _BIG)  # past the end: never taken
        if span < n:
            shifted[..., :n - span] = prev[..., span:]
        take_left = prev <= shifted  # ties -> leftmost
        torch.where(take_left, prev, shifted, out=vals[k + 1])
        if with_args:
            shifted_a = torch.full_like(prev, n)
            if span < n:
                shifted_a[..., :n - span] = args[k][..., span:]
            torch.where(take_left, args[k], shifted_a, out=args[k + 1])
        del shifted, take_left
        span *= 2
    return vals, args


def _level_of(length: torch.Tensor, n_levels: int) -> torch.Tensor:
    """floor(log2(length)) clipped into the table's level range (exact:
    every int32 length is a float64 whose exponent frexp returns)."""
    _, e = torch.frexp(length.to(torch.float64))
    return torch.clamp(e.to(torch.int64) - 1, 0, n_levels)


def _lookup(table: torch.Tensor, k: torch.Tensor,
            i: torch.Tensor) -> torch.Tensor:
    """``table[k, ..., i]`` elementwise, for queries whose leading
    dimensions match the table's rows."""
    n = table.shape[-1]
    rows = table[0].numel() // n
    lead = table.shape[1:-1]
    row = torch.arange(rows, device=table.device).reshape(*lead, 1) * n
    flat = k * (rows * n) + row + i.to(torch.int64)
    return table.reshape(-1)[flat]


def range_min(vals: torch.Tensor, lo: torch.Tensor,
              hi: torch.Tensor) -> torch.Tensor:
    """min over ``h[..., lo..hi]`` inclusive, elementwise; needs lo <= hi."""
    lo = lo.to(torch.int64)
    hi = hi.to(torch.int64)
    k = _level_of(hi - lo + 1, vals.shape[0] - 1)
    left = _lookup(vals, k, lo)
    right = _lookup(vals, k, torch.maximum(hi - (torch.ones_like(k) << k) + 1,
                                           lo))
    return torch.minimum(left, right)


def range_argmin(vals: torch.Tensor, args: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor) -> torch.Tensor:
    """Leftmost argmin over ``h[..., lo..hi]`` inclusive; needs lo <= hi."""
    lo = lo.to(torch.int64)
    hi = hi.to(torch.int64)
    k = _level_of(hi - lo + 1, vals.shape[0] - 1)
    hi2 = torch.maximum(hi - (torch.ones_like(k) << k) + 1, lo)
    take_left = _lookup(vals, k, lo) <= _lookup(vals, k, hi2)
    return torch.where(take_left, _lookup(args, k, lo), _lookup(args, k, hi2))


def prev_less(vals: torch.Tensor, init_pos: torch.Tensor,
              target: torch.Tensor) -> torch.Tensor:
    """Largest ``j < init_pos`` with ``h[j] < target``, by block skipping.

    Requires ``h[..., 0] < target`` for every queried target (a sentinel
    wall), so the result is always >= 0.  ``n_levels`` fixed trips,
    elementwise over ``init_pos``/``target``.  Returns int64."""
    n_levels = vals.shape[0] - 1
    pos = init_pos.to(torch.int64)
    for k in range(n_levels):
        step = 1 << (n_levels - 1 - k)
        cand = pos - step
        lo = torch.clamp(cand, min=0)
        blockmin = range_min(vals, lo, torch.maximum(pos - 1, lo))
        jump = (cand >= 1) & (blockmin >= target) & (pos - 1 >= lo)
        pos = torch.where(jump, cand, pos)
    return pos - 1

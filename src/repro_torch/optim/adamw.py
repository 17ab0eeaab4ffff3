"""AdamW + gradient clipping + schedules (the port of ``repro.optim.adamw``).

Plain functions on trees of tensors (:mod:`repro_torch.pytree`), not
``torch.optim.AdamW``: the moments are float32 whatever the parameters'
dtype, the state is JAX's layout (``step``, ``m``, ``v``), and every
quantity, the schedule's ``cos(pi * t)`` and the bias corrections' ``b **
step`` included, is a float32 tensor on the parameters' device, computed
in the JAX package's order; each new parameter is cast back to its dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch import pytree


# A donated leaf is updated in pieces of at most this many elements, so the
# update's float32 temporaries (the clipped gradient, the new moments, the
# step; ~8 of them) stay near 2 GB whatever the leaf (a stacked expert
# weight of phi3.5-moe is 3.4 GB in float32); elementwise, so the values
# are the same.
UPDATE_CHUNK = 1 << 26


class AdamWState(NamedTuple):
    step: torch.Tensor    # int32, 0-dim
    m: Any                # tree like params (float32)
    v: Any                # tree like params (float32)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"  # cosine | constant


def _device_of(tree) -> torch.device:
    first = pytree.leaves(tree)
    return first[0].device if first else torch.device("cpu")


def init(params) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=_device_of(params)),
        m=pytree.tree_map(zeros, params),
        v=pytree.tree_map(zeros, params),
    )


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    s = step.to(torch.float32)
    warm = torch.clamp((s + 1.0) / max(1, cfg.warmup_steps), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * t))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares, the leaves' sums added in flattening
    order onto a float32 zero (``jax.tree.reduce``'s order)."""
    total = torch.zeros((), dtype=torch.float32, device=_device_of(tree))
    for g in pytree.leaves(tree):
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return pytree.tree_map(lambda g: g.to(torch.float32) * scale, grads), norm


def _pieces(limit: int, *ts):
    """Views of the same-shaped tensors ``ts`` that cover them, each at
    most ``limit`` elements where a piece can be that small: runs of
    leading-dimension rows, or each row's own pieces when one row is
    larger.  Views of any layout (no copy)."""
    t0 = ts[0]
    if t0.dim() == 0 or t0.numel() <= limit:
        yield ts
        return
    per = t0.numel() // t0.shape[0]
    if per > limit and t0.dim() > 1:
        for i in range(t0.shape[0]):
            yield from _pieces(limit, *(t[i] for t in ts))
        return
    r = max(1, limit // per)
    for i in range(0, t0.shape[0], r):
        yield tuple(t[i:i + r] for t in ts)


def update(cfg: AdamWConfig, grads, state: AdamWState, params, *,
           donate: bool = False):
    """Returns (new_params, new_state, metrics).

    ``donate=True`` writes each leaf's new parameter and moments into the
    given ``params``, ``state.m`` and ``state.v`` tensors and returns
    them, one leaf at a time, so no second copy of the model and its
    moments is ever held (the counterpart of the JAX driver's
    ``donate_argnums``); the values are the same either way.  Each
    gradient is clipped as its leaf is updated (``clip_by_global_norm``'s
    product), so no clipped copy of the whole tree is held either, and a
    donated leaf is updated in pieces of at most ``UPDATE_CHUNK``
    elements (:func:`_pieces`).
    """
    gnorm = global_norm(grads)
    clip = _clip_scale(gnorm, cfg.clip_norm)
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    step_f = step.to(torch.float32)
    bc1 = 1.0 - torch.full((), b1, dtype=torch.float32, device=step.device) ** step_f
    bc2 = 1.0 - torch.full((), b2, dtype=torch.float32, device=step.device) ** step_f

    def upd(p, g, m, v):
        g = g.to(torch.float32) * clip
        m_new = b1 * m + (1.0 - b1) * g
        v_new = b2 * v + (1.0 - b2) * torch.square(g)
        mhat = m_new / bc1
        vhat = v_new / bc2
        pf = p.to(torch.float32)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * pf
        p_new = (pf - lr * delta).to(p.dtype)
        return p_new, m_new, v_new

    def upd_in_place(p, g, m, v):
        for sp, sg, sm, sv in _pieces(UPDATE_CHUNK, p, g, m, v):
            p_new, m_new, v_new = upd(sp, sg, sm, sv)
            sp.copy_(p_new)
            sm.copy_(m_new)
            sv.copy_(v_new)
        return p, m, v

    with torch.no_grad():
        out = [(upd_in_place if donate else upd)(p, g, m, v)
               for p, g, m, v in zip(
            pytree.leaves(params), pytree.leaves(grads),
            pytree.leaves(state.m), pytree.leaves(state.v))]
    new_p = pytree.unflatten_like(params, [o[0] for o in out])
    new_m = pytree.unflatten_like(params, [o[1] for o in out])
    new_v = pytree.unflatten_like(params, [o[2] for o in out])
    return new_p, AdamWState(step, new_m, new_v), {"grad_norm": gnorm, "lr": lr}

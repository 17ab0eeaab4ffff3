"""Train / prefill / decode step builders shared by the training driver
and the serving driver (the port of ``repro.launch.steps``)."""

from __future__ import annotations

import torch

from repro_torch import pytree
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy over all positions, in float32: ``logsumexp``
    minus the label's logit."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    return torch.mean(logz - ll)


def make_loss_fn(cfg: ModelConfig, *, aux_weight: float = 0.01,
                 remat_policy: str = "none"):
    def loss_fn(params, batch):
        logits, aux = T.forward_train(params, batch, cfg, remat=True,
                                      remat_policy=remat_policy)
        return cross_entropy(logits, batch["labels"]) + aux_weight * aux

    return loss_fn


def value_and_grad(loss_fn):
    """``jax.value_and_grad`` over the first argument, a parameter tree:
    the loss and a tree of gradients from ``torch.autograd.grad`` over
    detached leaves, so the caller's tensors gain no ``.grad`` and no
    graph, and the result is a function of the inputs alone."""
    def run(params, *args):
        leaves = [p.detach().requires_grad_(True)
                  for p in pytree.leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(pytree.unflatten_like(params, leaves), *args)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), pytree.unflatten_like(params, grads)

    return run


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    *, remat_policy: str = "none", donate: bool = False):
    """``train_step(params, opt_state, batch)`` → (new_params, new_opt,
    {"loss", "grad_norm", "lr"}).  ``donate=True`` updates the given
    parameters and moments in place (``adamw.update``), as the JAX driver
    donates them to the jitted step."""
    grad_fn = value_and_grad(make_loss_fn(cfg, remat_policy=remat_policy))

    def train_step(params, opt_state, batch):
        loss, grads = grad_fn(params, batch)
        new_params, new_opt, metrics = adamw.update(
            opt_cfg, grads, opt_state, params, donate=donate)
        return new_params, new_opt, {"loss": loss, **metrics}

    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch, cache):
        return T.forward_prefill(params, batch, cfg, cache)

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, greedy: bool = True):
    """Greedy decode: ``torch.argmax`` returns the first maximum, as
    ``jnp.argmax`` does."""
    def serve_step(params, tokens, cache):
        logits, cache = T.forward_decode(params, tokens, cfg, cache)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        return nxt, cache

    return serve_step

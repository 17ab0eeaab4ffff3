"""Prefill / decode step builders for LM serving (the port of
``repro.launch.steps``).  ``cross_entropy``, the loss and the train step
wait for ROADMAP A15b."""

from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


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

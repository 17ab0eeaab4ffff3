"""Architecture registry: ``--arch <id>`` → ModelConfig, plus the per-cell
inputs (the port of ``repro.models.registry``).

``ARCHS`` points at the port's own copies of the configs.
:func:`input_specs` gives every model input of a cell as a ``meta``
tensor (a shape and a dtype, no storage) and :func:`concrete_inputs` a
small batch of that structure on a device, drawn as the JAX package
draws it.  The dry run (:mod:`repro_torch.launch.dryrun`) reads the specs.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig, ShapeConfig

ARCHS = {
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
    "qwen1.5-32b": "repro_torch.configs.qwen1_5_32b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi3_5_moe",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[arch]).CONFIG


def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether (arch × shape) is a valid dry-run cell; reason if skipped.

    ``long_500k`` needs sub-quadratic attention: run for SSM/hybrid, skip
    for pure full-attention archs (incl. gemma3 — its global layers are
    full attention and its published context is 128k < 500k).
    """
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: long_500k skipped (DESIGN.md)"
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                dtype=torch.bfloat16) -> dict:
    """``meta`` tensors standing in for every model input of this cell,
    with the JAX package's keys (in its order), shapes and dtypes."""
    b, s = shape.global_batch, shape.seq_len

    def spec(shp, dt=torch.int32):
        return torch.empty(shp, dtype=dt, device="meta")

    if shape.kind == "train":
        if cfg.family == "encdec":
            # encoder frames + decoder tokens (frames len = seq len)
            return {"frontend": spec((b, s, cfg.frontend_dim), dtype),
                    "tokens": spec((b, s)), "labels": spec((b, s))}
        if cfg.frontend:  # vlm: patches + text (labels cover full sequence)
            return {"frontend": spec((b, cfg.frontend_len, cfg.frontend_dim),
                                     dtype),
                    "tokens": spec((b, s)),
                    "labels": spec((b, cfg.frontend_len + s))}
        return {"tokens": spec((b, s)), "labels": spec((b, s))}

    if shape.kind == "prefill":
        if cfg.family == "encdec":
            return {"frontend": spec((b, s, cfg.frontend_dim), dtype),
                    "tokens": spec((b, min(s, 1024)))}  # decoder prompt
        if cfg.frontend:
            return {"frontend": spec((b, cfg.frontend_len, cfg.frontend_dim),
                                     dtype),
                    "tokens": spec((b, s - cfg.frontend_len))}
        return {"tokens": spec((b, s))}

    # decode: one new token against a seq_len cache
    return {"tokens": spec((b, 1))}


def concrete_inputs(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                    dtype=torch.float32, device="cuda") -> dict:
    """A small concrete batch of :func:`input_specs`' structure on
    ``device``: one ``np.random.default_rng(seed)`` drawn key by key in
    the specs' order, integers in ``[0, vocab)`` for the int32 inputs and
    standard normals cast to ``dtype`` for the others, so the same seed
    gives the JAX package's arrays."""
    dev = ops.resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in input_specs(cfg, shape, dtype=dtype).items():
        if v.dtype == torch.int32:
            arr = torch.from_numpy(rng.integers(0, cfg.vocab, size=v.shape,
                                                dtype=np.int32))
        else:
            arr = torch.from_numpy(rng.normal(size=v.shape)).to(dtype)
        out[k] = arr.to(dev)
    return out

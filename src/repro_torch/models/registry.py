"""Architecture registry: ``--arch <id>`` → ModelConfig.

The port's counterpart of ``repro.models.registry``: ``ARCHS`` points at
the port's own copies of the configs.  The dry run's ``input_specs`` and
``concrete_inputs`` wait for ROADMAP item A15d.
"""

from __future__ import annotations

import importlib

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

"""The H100's rates — the port's own figures (``repro.roofline.analysis``
holds the TPU v5e's).

:class:`HopperLimits` is the one place for them: ``chip_smoke.py``
divides by them for every kernel's bound.  Figures: NVIDIA's H100 SXM
data sheet (dense rates, no sparsity, at the 700 W limit).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HopperLimits:
    """One H100 SXM (80 GB)."""

    hbm_bytes_per_s: float = 3.35e12   # device memory
    int32_ops_per_s: float = 67e12     # 32-bit non-tensor peak
    bf16_flops: float = 989e12         # dense bf16 tensor-core peak

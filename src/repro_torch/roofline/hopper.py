"""The H100's rates — the port's own figures (``repro.roofline.analysis``
holds the TPU v5e's).

:class:`HopperLimits` is the one place for them: ``chip_smoke.py``
divides by them for every kernel's bound, and the dry run's roofline
terms (:mod:`repro_torch.roofline.analysis`) by them for every cell.
Figures: NVIDIA's H100 SXM data sheet (dense rates, no sparsity, at the
700 W limit; NVLink 4 at 900 GB/s a GPU, 450 GB/s each way) and an HGX
H100 node of 8 GPUs with one 400 Gb/s NDR InfiniBand port per GPU
(50 GB/s each way) across nodes.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HopperLimits:
    """One H100 SXM (80 GB) in an 8-GPU NVLink node."""

    hbm_bytes_per_s: float = 3.35e12   # device memory
    int32_ops_per_s: float = 67e12     # 32-bit non-tensor peak
    bf16_flops: float = 989e12         # dense bf16 tensor-core peak
    nvlink_bytes_per_s: float = 450e9  # NVLink 4, one direction a GPU
    network_bytes_per_s: float = 50e9  # 400 Gb/s NDR port a GPU, one way
    gpus_per_node: int = 8             # one NVLink domain

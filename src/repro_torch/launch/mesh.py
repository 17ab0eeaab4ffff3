"""Fabric mesh construction — PyTorch port of ``repro.launch.mesh``
(``make_fabric_mesh``; the LM dry run's production and host meshes wait
for its port).

A mesh here is a sequence of :class:`torch.device`: shard ``k`` of the
fabric (:mod:`repro_torch.core.fabric`) runs on ``mesh[k % len(mesh)]``.
A FUNCTION, not a module-level constant: importing this module never
touches the CUDA runtime.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops


def make_fabric_mesh(n_shards: int | None = None,
                     device="cuda") -> list[torch.device]:
    """The first ``n_shards`` devices of ``device``'s type (default: all
    of them): every card for ``cuda``, the one CPU device for ``cpu``.
    Raises ``ValueError`` when there are fewer, and ``RuntimeError`` for
    ``cuda`` without a card.  A mesh in which a device repeats (``[cuda:0]
    * 4``, ``[cpu] * 3``) is never made here: callers pass one explicitly
    to run several shards on one device."""
    kind = kops.resolve_device(device).type
    if kind == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [torch.device("cpu")]
    n = len(devices) if n_shards is None else n_shards
    if not 1 <= n <= len(devices):
        raise ValueError(f"n_shards={n} needs 1..{len(devices)} {kind} "
                         "devices")
    return devices[:n]

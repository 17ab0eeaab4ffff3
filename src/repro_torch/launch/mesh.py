"""Mesh construction — PyTorch port of ``repro.launch.mesh``.

* :func:`make_production_mesh` / :func:`make_host_mesh` (via
  :func:`_make_mesh`): a :class:`~torch.distributed.device_mesh.DeviceMesh`
  with JAX's shapes and axis names — 16x16 (``data``, ``model``), 2x16x16
  (``pod``, ``data``, ``model``) and 1x1 — over the first ranks of the
  initialised process group; like ``jax.make_mesh`` they raise
  ``ValueError`` when the world holds fewer ranks than the mesh.
* :func:`fake_world`: a context that initialises a process group of ``n``
  ranks on the ``"fake"`` backend (this process is rank 0, no collective
  moves data) and always destroys it on exit; the dry run
  (:mod:`repro_torch.launch.dryrun`) traces every cell inside one.
* :func:`make_fabric_mesh`: the fabric's mesh, a sequence of
  :class:`torch.device` — shard ``k`` of the fabric
  (:mod:`repro_torch.core.fabric`) runs on ``mesh[k % len(mesh)]``.

FUNCTIONS, not module-level constants: importing this module touches
neither the CUDA runtime nor a process group.
"""

from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.kernels import ops as kops


def _world_size() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _make_mesh(shape, axes, device="cuda"):
    """A DeviceMesh of ``shape`` named ``axes`` over ranks ``0 ..
    prod(shape) - 1`` of the initialised group, row-major as
    ``jax.make_mesh`` lays devices out; ``device`` is the mesh's device
    type (``"cuda"`` or ``"cpu"``)."""
    n = math.prod(shape)
    world = _world_size()
    if world < n:
        raise ValueError(f"Number of devices {world} must be >= the product "
                         f"of mesh_shape {tuple(shape)}")
    from torch.distributed.device_mesh import DeviceMesh

    if world == 1 and not torch.distributed.is_initialized():
        raise RuntimeError("a DeviceMesh needs an initialised process "
                           "group: run inside fake_world(n) or after "
                           "torch.distributed.init_process_group")
    return DeviceMesh(torch.device(device).type,
                      torch.arange(n).view(*shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks with a ``pod`` axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device)


def make_host_mesh(device="cuda"):
    """Single-rank mesh (1x1, same axis names)."""
    return _make_mesh((1, 1), ("data", "model"), device)


@contextlib.contextmanager
def fake_world(n: int):
    """A process group of ``n`` ranks on the ``"fake"`` backend, this
    process rank 0, destroyed on exit whatever happens inside; refuses to
    start while another group is initialised."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


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

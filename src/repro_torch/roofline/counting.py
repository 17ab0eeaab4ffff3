"""Per-device accounting of a traced step — the port's stand-in for XLA's
``cost_analysis()``, ``memory_analysis()`` and the HLO collective parse.

:class:`DeviceCounter` is a ``TorchDispatchMode`` that sits below DTensor:
it declines every call on DTensors (returning ``NotImplemented``, as
``CommDebugMode`` does), so DTensor first turns the call into the ops one
device runs on its local shards — redistributions included — and the
counter sees exactly those.  Run the step on fake tensors
(``FakeTensorMode``) over a fake process group
(:func:`repro_torch.launch.mesh.fake_world`): nothing is computed and
nothing moves, and each op is counted once, as the device would run it.

It records, per device:

* ``flops`` — ``torch.utils.flop_counter``'s formulas (``mm``, ``bmm``,
  convolutions, SDPA, the registered ``repro_torch::flash_attention``)
  applied to each local op, so replicated compute counts on every
  device, as XLA's per-device SPMD program counts it;
* ``hbm_bytes`` — the local bytes of every input and output of every op
  that is not a view (views move nothing).  An UNFUSED upper bound: XLA's
  ``bytes accessed`` is counted after fusion, where an elementwise chain
  reads and writes memory once;
* ``collectives`` — one ``(kind, local result bytes, group size,
  in_node)`` record per functional collective (``all_reduce``,
  ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
  ``all_to_all_single``, DTensor's ``shard_dim_alltoall``, ``broadcast``
  counted as a permute), ``in_node`` True when every rank of the group
  sits in one ``gpus_per_node``-GPU node;
* ``ops`` — how many times each local op ran;
* peak memory — the local storages created during the step that are
  still referenced, tracked by weak references: :meth:`memory` reports
  them as JAX's ``memory_analysis()`` dict.

The fake mode is NOT active while the step runs: DTensor computes shard
offsets with small host tensors that must hold values.  The counter
makes the step's own tensors fake instead: a factory op (no tensor
argument) called from the step runs under ``fake_mode``, one called from
DTensor's internals runs for real on the host, and only ops on fake
tensors are counted.  DTensor also works out an op's global output shape
by running the op once on fake global tensors (its sharding propagator);
the counter pauses there, since no device runs that.

Two choices follow XLA's partitioner rather than DTensor's defaults: the
partial sums of a product over a split contracting dimension, and of a
lookup along a split dimension, are all-reduced at once (DTensor would
carry them as ``Partial`` and pick placements around them op by op); and
a view that DTensor's rule admits but the local shard's strides cannot
take runs as ``reshape`` does, on a contiguous copy.

Where DTensor has no sharding rule for an op, or its rule fails on the
local shards, the counter raises :class:`ShardingError` naming the op:
nothing is run on gathered arguments behind DTensor's back.  The dry run
(:mod:`repro_torch.launch.dryrun`) supplies what the port's cells need;
a cell that still meets such an op ends ``error``.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import sys
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline.hopper import HopperLimits

# functional collective -> (HLO kind, index of its group-name argument)
_COLLECTIVES = {
    "all_reduce": ("all-reduce", 2),
    "all_gather_into_tensor": ("all-gather", 2),
    "reduce_scatter_tensor": ("reduce-scatter", 3),
    "all_to_all_single": ("all-to-all", 3),
    "shard_dim_alltoall": ("all-to-all", 3),
    "broadcast": ("collective-permute", 2),
}
_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")
_HERE = os.path.abspath(__file__)
_TORCH = os.path.dirname(os.path.abspath(torch.__file__))
_DISTRIBUTED = os.path.join(_TORCH, "distributed") + os.sep
_PORT = os.path.dirname(os.path.dirname(_HERE)) + os.sep


# ops whose partial results are reduced at once, as XLA's partitioner
# all-reduces a dot over a split contracting dimension: the products, and
# lookups along a split dimension (the embedding's rows, the loss's label
# logit)
_REDUCED_AT_ONCE = {torch.ops.aten.mm, torch.ops.aten.bmm,
                    torch.ops.aten.addmm, torch.ops.aten.baddbmm,
                    torch.ops.aten.gather, torch.ops.aten.index,
                    torch.ops.aten.embedding}


def _reduced(out):
    """``out`` with its partial placements all-reduced (a DTensor), or as
    it is."""
    from torch.distributed.tensor import Replicate

    if not isinstance(out, DTensor) or not any(p.is_partial()
                                               for p in out.placements):
        return out
    return out.redistribute(out.device_mesh, [
        Replicate() if p.is_partial() else p for p in out.placements])


def _unviewable(e: Exception) -> bool:
    return isinstance(e, (RuntimeError, ValueError)) and \
        str(e).startswith("Cannot view a tensor with shape")


def _called_from_distributed() -> bool:
    """Whether the nearest caller outside this module and outside torch's
    dispatch machinery is torch.distributed (DTensor's internals) rather
    than the port (the step)."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if path.startswith(_DISTRIBUTED):
            return True
        if path.startswith(_PORT) and path != _HERE:
            return False
        f = f.f_back
    return False


def _storage_key(t: torch.Tensor):
    return t.untyped_storage()._cdata


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    return getattr(t, "_local_tensor", t)


def storage_bytes(tree) -> tuple[int, set]:
    """(bytes, storage keys) of the distinct local storages of the tensors
    (DTensors: their local shards) in ``tree``."""
    seen: dict = {}
    for t in _tensors(tree):
        loc = _local(t)
        seen[_storage_key(loc)] = loc.untyped_storage().nbytes()
    return sum(seen.values()), set(seen)


class ShardingError(RuntimeError):
    """DTensor could not run an op on the traced placements; the message
    starts with the op."""


@dataclasses.dataclass
class DeviceCounts:
    flops: int = 0
    hbm_bytes: int = 0
    collectives: list = dataclasses.field(default_factory=list)
    ops: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)


class DeviceCounter(TorchDispatchMode):
    """See the module docstring.  ``arguments``: the step's inputs, whose
    storages are resident before the step and not counted as new."""

    def __init__(self, fake_mode, arguments=()):
        super().__init__()
        self.fake_mode = fake_mode
        self.counts = DeviceCounts()
        self._node = HopperLimits().gpus_per_node
        self.argument_bytes, self._resident = storage_bytes(arguments)
        self._refs: dict = {}      # storage key -> [bytes, live tensors]
        self._seen: set[int] = set()  # ids of the tracked tensors
        self.live = self.peak = 0
        self._groups: dict = {}
        self._paused = 0
        self._depth = 0
        self._defer = False

    def __enter__(self):
        self._depth += 1
        if self._depth == 1:
            from torch.distributed.tensor._sharding_prop import (
                ShardingPropagator)

            name = "_propagate_tensor_meta_non_cached"
            original = getattr(ShardingPropagator, name)
            self._patched = (ShardingPropagator, name, original)

            def paused(prop, *args, **kwargs):
                self._paused += 1
                try:
                    return original(prop, *args, **kwargs)
                finally:
                    self._paused -= 1

            setattr(ShardingPropagator, name, paused)
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if self._depth == 0:
            cls, name, original = self._patched
            setattr(cls, name, original)
        return super().__exit__(*exc)

    # -- dispatch -------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self._defer:  # the call _dtensor_call re-issued: DTensor's
                self._defer = False
                return NotImplemented
            return self._dtensor_call(func, args, kwargs)
        tensors = _tensors((args, kwargs))
        if not tensors and not _called_from_distributed():
            with self.fake_mode:  # a factory of the step
                out = func(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
            if not any(isinstance(t, FakeTensor) for t in tensors):
                return out  # host metadata (or DTensor's own factories)
        if self._paused or not isinstance(func, torch._ops.OpOverload):
            return out
        packet = func._overloadpacket
        c = self.counts
        c.ops[str(packet)] += 1
        formula = flop_registry.get(packet)
        if formula is not None:
            c.flops += formula(*args, **kwargs, out_val=out)
        outs = _tensors(out)
        if outs and not func.is_view:
            c.hbm_bytes += sum(t.nbytes for t in _tensors((args, kwargs)))
            c.hbm_bytes += sum(t.nbytes for t in outs)
        ns, name = func.namespace, packet.__name__
        if ns in _NAMESPACES and name in _COLLECTIVES:
            kind, gi = _COLLECTIVES[name]
            g, in_node = self._group(args[gi])
            c.collectives.append((kind, sum(t.nbytes for t in outs), g,
                                  in_node))
        for t in outs:
            self._track(t)
        return out

    def _dtensor_call(self, func, args, kwargs):
        """Let DTensor run ``func`` with this counter active, so its local
        ops and redistributions are counted; an op DTensor cannot shard
        raises :class:`ShardingError` naming it."""
        self._defer = True
        try:
            with self:
                out = func(*args, **kwargs)
                if func._overloadpacket in _REDUCED_AT_ONCE:
                    out = _reduced(out)
                return out
        except ShardingError:
            raise
        except Exception as e:
            if self._paused:
                raise
            if func is torch.ops.aten.view.default and _unviewable(e):
                return self._copied_view(args[0], args[1])
            placed = [f"{tuple(a.shape)} {tuple(a.placements)}"
                      for a in tree_leaves((args, kwargs))
                      if isinstance(a, DTensor)]
            raise ShardingError(f"{func} on {placed}: "
                                f"{type(e).__name__}: {e}") from e
        finally:
            self._defer = False

    def _copied_view(self, x, shape):
        """``x.view(shape)`` where DTensor's rule admits the view but the
        local shard's strides cannot be viewed (a size-1 local dimension
        of a split dimension keeps an arbitrary stride): the view of a
        contiguous copy, which is what ``reshape`` runs on a tensor it
        cannot view, and counted as such."""
        with self:
            copy = torch.ops.aten.clone.default(
                x, memory_format=torch.contiguous_format)
            return torch.ops.aten._unsafe_view.default(copy, shape)

    def _group(self, name: str) -> tuple[int, bool]:
        if name not in self._groups:
            import torch.distributed as dist
            from torch.distributed.distributed_c10d import _resolve_process_group

            ranks = dist.get_process_group_ranks(_resolve_process_group(name))
            nodes = {r // self._node for r in ranks}
            self._groups[name] = (len(ranks),
                                  len(ranks) <= self._node and len(nodes) == 1)
        return self._groups[name]

    # -- live storages --------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        if id(t) in self._seen:
            return
        key = _storage_key(t)
        if key in self._resident:
            return
        self._seen.add(id(t))
        ref = self._refs.get(key)
        if ref is None:
            ref = self._refs[key] = [t.untyped_storage().nbytes(), 0]
            self.live += ref[0]
            self.peak = max(self.peak, self.live)
        ref[1] += 1
        weakref.finalize(t, self._release, key, id(t))

    def _release(self, key, tid: int) -> None:
        self._seen.discard(tid)
        ref = self._refs.get(key)
        if ref is None:
            return
        ref[1] -= 1
        if ref[1] == 0:
            self.live -= ref[0]
            del self._refs[key]

    def memory(self, outputs) -> dict:
        """JAX's ``memory_analysis()`` figures for the step that returned
        ``outputs``, per device:

        * ``argument_bytes`` — the local storages of the step's inputs;
        * ``output_bytes`` — the local storages of its outputs;
        * ``alias_bytes`` — the outputs' storages that ARE input storages
          (written in place: the donated parameters, moments and cache);
        * ``temp_bytes`` — the peak of the storages the step created,
          less the new outputs it ends with;
        * ``peak_estimate_bytes`` — argument + output + temp − alias:
          the inputs plus the peak of everything created.
        """
        out_bytes, out_keys = storage_bytes(outputs)
        alias, _ = storage_bytes([t for t in _tensors(outputs)
                                  if _storage_key(_local(t)) in self._resident])
        temp = max(0, self.peak - (out_bytes - alias))
        return {
            "argument_bytes": self.argument_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": temp,
            "alias_bytes": alias,
            "peak_estimate_bytes": (self.argument_bytes + out_bytes + temp
                                    - alias),
        }

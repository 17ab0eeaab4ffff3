"""Roofline terms of a dry-run cell — the port of
``repro.roofline.analysis``.

Three terms per (arch × shape × mesh), in seconds, per device:

  compute    = flops      / limits.bf16_flops
  memory     = hbm_bytes  / limits.hbm_bytes_per_s
  collective = wire bytes / the link rate of each collective's group

The figures come from the dispatch-level accounting of a traced step
(:mod:`repro_torch.roofline.counting`), not from a compiled artefact:
each collective is recorded as (kind, local result bytes, group size,
whether its group stays in one NVLink node), where the JAX package parses
the same three facts from the compiled HLO.  The bytes a device moves
over the wire are JAX's:

  all-reduce       2·(g-1)/g · result     (ring)
  all-gather       (g-1)/g · result       (result = gathered buffer)
  reduce-scatter   (g-1)/g · operand      (operand = g × result)
  all-to-all       (g-1)/g · result
  collective-permute  result

The rates are :class:`~repro_torch.roofline.hopper.HopperLimits` unless a
limits object is given.  A group of at most ``gpus_per_node`` ranks that
all sit in one node (ranks ``r // gpus_per_node`` equal) is charged at
the NVLink rate; a larger group, or one that crosses a node, at the
network rate.
"""

from __future__ import annotations

import dataclasses

from repro_torch.roofline.hopper import HopperLimits

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def wire_bytes(kind: str, result_bytes: float, g: int) -> float:
    """Bytes one device moves over the wire for one collective of
    ``kind`` with ``result_bytes`` of local result over a group of
    ``g``."""
    frac = (g - 1) / g if g > 1 else 0.0
    if kind == "all-reduce":
        return 2.0 * frac * result_bytes
    if kind == "all-gather":
        return frac * result_bytes
    if kind == "reduce-scatter":
        return frac * result_bytes * g  # operand = g × result
    if kind == "all-to-all":
        return frac * result_bytes
    if kind == "collective-permute":
        return float(result_bytes)
    raise ValueError(f"unknown collective kind {kind!r}")


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict
    count_by_kind: dict
    wire_bytes: float          # per-device bytes moved over the wire
    network_wire_bytes: float = 0.0  # of which across nodes

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_kind.values()))


def collective_stats(records) -> CollectiveStats:
    """Sum ``(kind, result_bytes, g, in_node)`` records, in order, as
    ``repro.roofline.analysis.parse_collectives`` sums HLO lines."""
    bytes_by_kind: dict[str, float] = {}
    count_by_kind: dict[str, int] = {}
    wire = net = 0.0
    for kind, result_bytes, g, in_node in records:
        w = wire_bytes(kind, result_bytes, g)
        bytes_by_kind[kind] = bytes_by_kind.get(kind, 0.0) + result_bytes
        count_by_kind[kind] = count_by_kind.get(kind, 0) + 1
        wire += w
        if not in_node:
            net += w
    return CollectiveStats(bytes_by_kind, count_by_kind, wire, net)


@dataclasses.dataclass
class RooflineTerms:
    flops: float        # per device (the traced local work)
    hbm_bytes: float    # per device
    wire_bytes: float   # per device, every collective
    chips: int
    model_flops: float = 0.0  # GLOBAL useful flops (6·N·D)
    network_wire_bytes: float = 0.0  # the part of wire_bytes across nodes
    limits: HopperLimits = dataclasses.field(default_factory=HopperLimits)

    @property
    def t_compute(self) -> float:
        return self.flops / self.limits.bf16_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.limits.hbm_bytes_per_s

    @property
    def t_collective(self) -> float:
        node = self.wire_bytes - self.network_wire_bytes
        return (node / self.limits.nvlink_bytes_per_s
                + self.network_wire_bytes / self.limits.network_bytes_per_s)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """No-overlap roofline estimate (upper bound on achievable)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu_upper_bound(self) -> float:
        """Model-flops utilization at the roofline step time."""
        denom = self.step_time * self.chips * self.limits.bf16_flops
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "wire_bytes": self.wire_bytes, "chips": self.chips,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_upper_bound": self.mfu_upper_bound,
        }


def terms_from_counts(counts, chips: int, model_flops: float,
                      limits: HopperLimits | None = None):
    """(RooflineTerms, CollectiveStats) of a traced step's
    :class:`~repro_torch.roofline.counting.DeviceCounts` — the counterpart
    of ``terms_from_compiled``."""
    coll = collective_stats(counts.collectives)
    terms = RooflineTerms(
        flops=float(counts.flops), hbm_bytes=float(counts.hbm_bytes),
        wire_bytes=coll.wire_bytes, chips=chips, model_flops=model_flops,
        network_wire_bytes=coll.network_wire_bytes,
        limits=limits or HopperLimits())
    return terms, coll

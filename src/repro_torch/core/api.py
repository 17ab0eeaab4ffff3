"""EraIndexer — the end-to-end ERA pipeline, PyTorch port of ``repro.core.api``.

This slice ports the main path, :meth:`EraIndexer.build_device`:

    vertical partitioning → grouping → device text (dense k-bit words,
    or the terminal-padded byte string) → batched elastic-range
    SubTreePrepare on the (G, F) state → flatten to suffix-array order →
    :class:`repro_torch.core.query.DeviceIndex`

``EraConfig.packing`` picks the text as in the JAX package: ``auto``
packs alphabets below 8 bits (DNA, protein classes) dense and keeps
protein, english and byte strings one byte per symbol; ``bytes`` keeps any
alphabet byte per symbol.  Everything runs on the indexer's ``device``
(``"cuda"`` by default; ``"cpu"`` runs every kernel's plain version).  The
serial engine and the node build are later slices of the port and are
refused with ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core.alphabet import Alphabet
from repro_torch.core.prepare import (
    ElasticConfig,
    PrepareStats,
    segments_of,
    subtree_prepare_batch,
)
from repro_torch.core.vertical import VerticalStats, vertical_partition_grouped
from repro_torch.kernels import ops as kops

NODE_BYTES = 16  # sizeof(tree_node): parent + depth + witness + pad (SoA)
_BUILD_IMPLS = ("numpy", "scan", "parallel", "none")


@dataclasses.dataclass(frozen=True)
class EraConfig:
    """Memory-budget and strategy knobs (paper §4.4 memory allocation);
    the same fields and defaults as the JAX ``EraConfig``."""

    memory_bytes: int = 64 << 20   # total budget; 60% to the sub-tree (MTS)
    r_bytes: int = 1 << 20         # |R| read buffer
    w_min: int = 4
    w_max: int = 256
    elastic: bool = True
    static_w: int = 16             # used when elastic=False (Fig. 9b ablation)
    group: bool = True             # virtual trees on/off (Fig. 9a ablation)
    vertical_strategy: str = "histogram"  # or "positions" (beyond-paper)
    build_impl: str = "numpy"      # node builder; build_device never builds nodes
    construction: str = "batched"  # batched (one (G,F) loop) | serial
    packing: str = "auto"          # auto | dense | bytes (device string form)
    sort_fuse: bool | None = None  # None = REPRO_SORT (fused unless lexsort)
    compaction: bool | None = None  # None = REPRO_COMPACT (tail unless off)
    node_lcp: str = "state"        # state | words (node build divergence source)

    @property
    def mts_bytes(self) -> int:
        return int(0.6 * self.memory_bytes)

    @property
    def f_max(self) -> int:
        """Eq. 1: F_M = MTS / (2 * sizeof(tree_node))."""
        return max(2, self.mts_bytes // (2 * NODE_BYTES))

    @property
    def r_symbols(self) -> int:
        return self.r_bytes  # 1 byte per symbol code in this implementation

    def elastic_config(self) -> ElasticConfig:
        return ElasticConfig(
            r_budget_symbols=self.r_symbols,
            w_min=self.w_min,
            w_max=self.w_max,
            elastic=self.elastic,
            static_w=self.static_w,
        )


@dataclasses.dataclass
class BuildReport:
    vertical: VerticalStats
    prepare: PrepareStats
    n_prefixes: int = 0
    n_groups: int = 0
    f_max: int = 0
    capacity: int = 0  # F of the (G, F) prepare state
    t_vertical: float = 0.0
    t_prepare: float = 0.0
    t_build: float = 0.0

    @property
    def t_total(self) -> float:
        return self.t_vertical + self.t_prepare + self.t_build


def _sorted_segments(groups):
    """(prefix, group_index, offset, freq) per sub-tree, sorted by prefix —
    prefix-freeness makes this the suffix-array order of the segments."""
    entries = []
    for g_i, g in enumerate(groups):
        for (off, freq), p in zip(segments_of(g), g.prefixes):
            entries.append((p.symbols, g_i, off, freq))
    entries.sort(key=lambda e: e[0])
    return entries


def _flatten_state(groups, states):
    """(prefixes, freqs, ell) in sorted prefix order from a final (G, F)
    prepare state: ``ell`` is one gather on the state's device, indexed
    by a flat index built there with ``repeat_interleave``."""
    entries = _sorted_segments(groups)
    f_cap = states.L.shape[1]
    dev = states.L.device
    freq = torch.tensor([e[3] for e in entries], dtype=torch.int64, device=dev)
    seg = torch.tensor([e[1] * f_cap + e[2] for e in entries],
                       dtype=torch.int64, device=dev)
    first = torch.cumsum(freq, 0) - freq
    total = int(freq.sum())
    flat_idx = (torch.repeat_interleave(seg - first, freq)
                + torch.arange(total, device=dev))
    ell = states.L.reshape(-1)[flat_idx]
    prefixes = [e[0] for e in entries]
    freqs = np.array([e[3] for e in entries], np.int32)
    return prefixes, freqs, ell


class EraIndexer:
    def __init__(self, alphabet: Alphabet, config: EraConfig = EraConfig(),
                 *, device="cuda"):
        self.alphabet = alphabet
        self.config = config
        if config.construction not in ("serial", "batched"):
            raise ValueError(
                f"unknown construction engine {config.construction!r}; "
                "choose 'serial' or 'batched'")
        if config.packing not in ("auto", "dense", "bytes"):
            raise ValueError(
                f"unknown packing mode {config.packing!r}; "
                "choose 'auto', 'dense' or 'bytes'")
        if config.build_impl not in _BUILD_IMPLS:
            raise ValueError(
                f"unknown build_impl {config.build_impl!r}; "
                f"choose one of {sorted(_BUILD_IMPLS)}")
        if config.node_lcp not in ("state", "words"):
            raise ValueError(
                f"unknown node_lcp {config.node_lcp!r}; "
                "choose 'state' or 'words'")
        if config.construction == "serial":
            raise NotImplementedError(
                "construction='serial' is not ported yet (ROADMAP A14); "
                "the batched engine gives identical arrays")
        self.device = kops.resolve_device(device)

    def partition(self, s: np.ndarray, report: BuildReport | None = None):
        """Vertical partitioning + grouping (the master-node phase)."""
        cfg = self.config
        vstats = report.vertical if report else VerticalStats()
        t0 = time.perf_counter()
        groups = vertical_partition_grouped(
            s,
            base=self.alphabet.base,
            f_max=cfg.f_max,
            strategy=cfg.vertical_strategy,
            group=cfg.group,
            stats=vstats,
            device=self.device,
        )
        if report:
            report.t_vertical = time.perf_counter() - t0
            report.n_groups = len(groups)
            report.n_prefixes = sum(len(g.prefixes) for g in groups)
            report.f_max = cfg.f_max
        return groups

    def _capacity(self, groups) -> int:
        return min(self.config.f_max,
                   max((g.total_freq for g in groups), default=2))

    def _pad(self, s: np.ndarray) -> torch.Tensor:
        """The terminal-padded uint8 string on the device: reads up to
        ``2 * w_max + 8`` symbols past the end stay in bounds."""
        padded = self.alphabet.pad_string(s, extra=2 * self.config.w_max + 8)
        return torch.from_numpy(padded).to(self.device)

    def _device_text(self, s: np.ndarray):
        """The device-resident string for construction reads: the dense
        :class:`packing.PackedText` or the terminal-padded byte string, per
        ``EraConfig.packing``; construction output is identical."""
        if packing.resolve_dense(self.config.packing, self.alphabet):
            return packing.pack_text(s, self.alphabet,
                                     extra=2 * self.config.w_max + 8,
                                     device=self.device)
        return self._pad(s)

    def _prepare_batched(self, s: np.ndarray, report: BuildReport):
        """partition → padded (G, F) batched prepare, timing into ``report``.
        Returns (groups, states, s_padded); states is None without groups."""
        groups = self.partition(s, report)
        if not groups:
            return groups, None, None
        capacity = self._capacity(groups)
        report.capacity = capacity
        s_padded = self._device_text(s)
        t0 = time.perf_counter()
        states = subtree_prepare_batch(s_padded, groups, capacity,
                                       self.config.elastic_config(),
                                       report.prepare,
                                       sort_fuse=self.config.sort_fuse,
                                       compact=self.config.compaction)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        report.t_prepare = time.perf_counter() - t0
        return groups, states, s_padded

    def build_device(self, s: np.ndarray, report: BuildReport | None = None,
                     **device_kwargs):
        """String → :class:`repro_torch.core.query.DeviceIndex`.

        The leaf arrays go straight from the (G, F) prepare state into
        suffix-array order with one device gather — no per-prefix sub-tree
        dict and no node build.  ``device_kwargs``: ``route_cap``,
        ``max_pattern_len``, ``packing`` (defaults to the config's).
        """
        from repro_torch.core.query import DeviceIndex  # local: import cycle

        report = report if report is not None else BuildReport(
            VerticalStats(), PrepareStats())
        device_kwargs.setdefault("packing", self.config.packing)
        groups, states, _ = self._prepare_batched(s, report)
        if states is None:
            raise ValueError("cannot flatten an empty index")
        prefixes, freqs, ell = _flatten_state(groups, states)
        del states
        return DeviceIndex.from_prepare(
            alphabet=self.alphabet,
            s=np.asarray(s),
            prefixes=prefixes,
            freqs=freqs,
            ell=ell,
            device=self.device,
            **device_kwargs,
        )

"""EraIndexer — the end-to-end ERA pipeline, PyTorch port of ``repro.core.api``.

Two builds share the batched front end — vertical partitioning →
grouping → device text (dense k-bit words, or the terminal-padded byte
string) → batched elastic-range SubTreePrepare on the (G, F) state:

* :meth:`EraIndexer.build_device` flattens the state straight to
  suffix-array order → :class:`repro_torch.core.query.DeviceIndex`;
* :meth:`EraIndexer.build` slices it into per-prefix sub-trees and builds
  their nodes with the batched Cartesian-tree builder (divergence rows
  from the stored ``b_off`` or, with ``EraConfig(node_lcp="words")``,
  recomputed from the text) → :class:`SuffixTreeIndex`, whose
  ``analytics()`` is the :class:`repro_torch.core.analytics.AnalyticsEngine`
  (:meth:`EraIndexer.build_analytics` does both).

``EraConfig.packing`` picks the text as in the JAX package: ``auto``
packs alphabets below 8 bits (DNA, protein classes) dense and keeps
protein, english and byte strings one byte per symbol; ``bytes`` keeps any
alphabet byte per symbol.  Everything runs on the indexer's ``device``
(``"cuda"`` by default; ``"cpu"`` runs every kernel's plain version).  The
serial engine is a later slice of the port and is refused with
``NotImplementedError`` naming its ROADMAP item (A14).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import build as build_mod
from repro_torch.core import packing
from repro_torch.core.alphabet import Alphabet
from repro_torch.core.prepare import (
    ElasticConfig,
    PrepareStats,
    segments_of,
    subtree_prepare_batch,
)
from repro_torch.core.suffix_tree import SubTree, SuffixTreeIndex
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
    build_impl: str = "numpy"      # "none" skips nodes; batched builds use the parallel builder
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


def _entry_flat_idx(entry, f_cap: int) -> np.ndarray:
    """Indices of one sub-tree's leaf segment in the flattened (G, F) state."""
    _, g_i, off, freq = entry
    return g_i * f_cap + off + np.arange(freq, dtype=np.int64)


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

    # ---- sub-tree builds ---------------------------------------------------

    def process_groups(self, s_text, groups, capacity: int,
                       pstats: PrepareStats | None = None
                       ) -> list[list[SubTree]]:
        """SubTreePrepare + slicing for MANY virtual trees through the
        batched (G, F) engine; one ``list[SubTree]`` per input group."""
        states = subtree_prepare_batch(s_text, groups, capacity,
                                       self.config.elastic_config(), pstats,
                                       sort_fuse=self.config.sort_fuse,
                                       compact=self.config.compaction)
        host = _HostState(states)
        return [self._slice_subtrees(host.group(g_i), g)
                for g_i, g in enumerate(groups)]

    @staticmethod
    def _slice_subtrees(state, group) -> list[SubTree]:
        """One group's host state cut into per-prefix sub-trees (b_off[0]
        of each segment zeroed, as in the JAX package)."""
        out = []
        for (off, f), p in zip(segments_of(group), group.prefixes):
            seg_b = state.b_off[off : off + f].copy()
            seg_b[0] = 0
            out.append(SubTree(
                prefix=p.symbols,
                ell=state.L[off : off + f].copy(),
                b_off=seg_b,
                b_c1=state.b_c1[off : off + f].copy(),
                b_c2=state.b_c2[off : off + f].copy(),
            ))
        return out

    def build(self, s: np.ndarray,
              report: BuildReport | None = None) -> SuffixTreeIndex:
        """String → :class:`SuffixTreeIndex` (sub-trees with their nodes,
        unless ``build_impl="none"``) on the indexer's device."""
        report = report if report is not None else BuildReport(
            VerticalStats(), PrepareStats())
        return self._build_batched(s, report)

    def _build_batched(self, s: np.ndarray,
                       report: BuildReport) -> SuffixTreeIndex:
        groups, states, s_text = self._prepare_batched(s, report)
        subtrees: dict[tuple, SubTree] = {}
        if states is not None:
            t0 = time.perf_counter()
            host = _HostState(states)
            for g_i, g in enumerate(groups):
                for st in self._slice_subtrees(host.group(g_i), g):
                    subtrees[st.prefix] = st
            report.t_prepare += time.perf_counter() - t0

            t0 = time.perf_counter()
            if self.config.build_impl != "none":
                self._attach_nodes_batched(states, groups, subtrees, len(s),
                                           s_text=s_text)
            report.t_build = time.perf_counter() - t0
        return SuffixTreeIndex(s=np.asarray(s), alphabet=self.alphabet,
                               subtrees=subtrees, device=self.device)

    def _attach_nodes_batched(self, states, groups, subtrees, n_total: int,
                              s_text=None) -> None:
        """All sub-trees' node sets through size-bucketed batched builds.

        Per-prefix (ell, b_off) segments are gathered on the device into
        depth-0 padded rows (see :mod:`repro_torch.core.build`), grouped
        into pad-width buckets (:func:`build.bucket_pad_widths`), built
        by the batched Cartesian-tree builder in row chunks under its byte
        budget, and cut to each sub-tree's compact node set on the device
        before one host copy (:func:`build.unpad_nodes_rows`).  With
        ``EraConfig(node_lcp="words")`` the divergence rows come from the
        text (:func:`build.boff_rows_from_text`) instead of the stored
        ``b_off``; the node sets are identical.
        """
        use_words = self.config.node_lcp == "words" and s_text is not None
        entries = _sorted_segments(groups)
        f_cap = states.L.shape[1]
        dev = states.L.device
        flat_L = states.L.reshape(-1)
        flat_b = states.b_off.reshape(-1)
        for f_pad, rows in build_mod.bucket_pad_widths(
                [e[3] for e in entries]):
            idx = np.zeros((len(rows), f_pad), np.int64)
            mask = np.zeros((len(rows), f_pad), bool)
            for r, e_i in enumerate(rows):
                freq = entries[e_i][3]
                idx[r, :freq] = _entry_flat_idx(entries[e_i], f_cap)
                mask[r, :freq] = True
            idx = torch.from_numpy(idx).to(dev)
            mask = torch.from_numpy(mask).to(dev)
            ell_rows = torch.where(mask, flat_L[idx], n_total)
            if use_words:
                boff_rows = build_mod.boff_rows_from_text(s_text, ell_rows,
                                                          n_total)
            else:
                boff_rows = torch.where(mask, flat_b[idx], 0)
            del idx, mask
            nodes = build_mod.build_parallel_batch(ell_rows, boff_rows,
                                                   n_total)
            compact = build_mod.unpad_nodes_rows(
                nodes, [entries[e_i][3] for e_i in rows])
            for e_i, node_set in zip(rows, compact):
                subtrees[entries[e_i][0]].nodes = node_set

    def build_analytics(self, s: np.ndarray,
                        report: BuildReport | None = None, **device_kwargs):
        """Build + flatten + LCP in one step: ``(index, engine)``, the
        engine being :class:`repro_torch.core.analytics.AnalyticsEngine`.
        Flattening kwargs default ``packing`` to this indexer's config."""
        index = self.build(s, report)
        if device_kwargs or self.config.packing != "auto":
            # a non-default packing builds an uncached engine ("auto" keeps
            # the index's shared cache, whose default is the same "auto")
            device_kwargs.setdefault("packing", self.config.packing)
        return index, index.analytics(**device_kwargs)

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


class _HostState:
    """One bulk device→host transfer of a (G, F) state, sliceable per group."""

    def __init__(self, states):
        self.L = states.L.cpu().numpy()
        self.b_off = states.b_off.cpu().numpy()
        self.b_c1 = states.b_c1.cpu().numpy()
        self.b_c2 = states.b_c2.cpu().numpy()

    def group(self, g_i: int) -> "_HostState":
        view = object.__new__(_HostState)
        view.L = self.L[g_i]
        view.b_off = self.b_off[g_i]
        view.b_c1 = self.b_c1[g_i]
        view.b_c2 = self.b_c2[g_i]
        return view

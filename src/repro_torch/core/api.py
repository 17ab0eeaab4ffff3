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

:meth:`EraIndexer.build_stream` is the out-of-core build (the groups in
device-budget chunks, host state double-buffered onto the card), and
:meth:`EraIndexer.append_device` extends a built index to a longer
string, rebuilding only the sub-trees the appended symbols touch.
:meth:`EraIndexer.build_sharded` and :meth:`EraIndexer.append_sharded`
build and extend a :class:`repro_torch.core.fabric.ShardedIndex`: the
prepare over a mesh of devices, the leaf arrays cut into route-key
shards.

``EraConfig(construction="serial")`` makes :meth:`EraIndexer.build` the
paper's serial engine (§4): one group at a time through
:func:`repro_torch.core.prepare.subtree_prepare`, then the per-prefix
builder ``build_impl`` names (``numpy``, ``scan`` or ``parallel``); the
arrays equal the batched engine's.  :meth:`EraIndexer.process_groups`
is the unit of work of the worker driver
(:mod:`repro_torch.launch.era_run`).

``EraConfig.packing`` picks the text as in the JAX package: ``auto``
packs alphabets below 8 bits (DNA, protein classes) dense and keeps
protein, english and byte strings one byte per symbol; ``bytes`` keeps any
alphabet byte per symbol.  Everything runs on the indexer's ``device``
(``"cuda"`` by default; ``"cpu"`` runs every kernel's plain version).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import build as build_mod
from repro_torch.core import packing
from repro_torch.core.alphabet import Alphabet
from repro_torch.core.prepare import (
    ElasticConfig,
    PrepareStats,
    StreamReport,
    segments_of,
    subtree_prepare,
    subtree_prepare_batch,
    subtree_prepare_stream,
)
from repro_torch.core.suffix_tree import SubTree, SuffixTreeIndex
from repro_torch.core.vertical import (
    SubTreePrefix,
    VerticalStats,
    group_prefixes,
    vertical_partition_grouped,
)
from repro_torch.kernels import ops as kops

NODE_BYTES = 16  # sizeof(tree_node): parent + depth + witness + pad (SoA)


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
    build_impl: str = "numpy"      # numpy | scan | parallel: the serial engine's
    #                                per-prefix builder; "none" skips nodes;
    #                                batched builds use the parallel builder
    construction: str = "batched"  # batched (one (G,F) loop) | serial (per group)
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
    """What one build did and how long each stage took (host clock).

    ``t_text``, ``t_flatten`` and ``t_slice`` time the spans ``build/text``,
    ``build/flatten`` and ``build/slice``; ``t_slice`` is also inside
    ``t_prepare``.  ``bytes_to_host`` / ``bytes_to_device`` add up the
    ``nbytes`` of every copy between host and device whose size grows
    with the string or the number of sub-trees (a scalar or a vector of G
    entries read back is left out), counted on a CPU device too, where a
    copy moves nothing.  The batched builds and the stream count every
    stage; the serial engine counts its partition and text."""

    vertical: VerticalStats
    prepare: PrepareStats
    n_prefixes: int = 0
    n_groups: int = 0
    f_max: int = 0
    capacity: int = 0  # F of the (G, F) prepare state
    t_vertical: float = 0.0
    t_prepare: float = 0.0
    t_build: float = 0.0
    t_text: float = 0.0     # the construction text packed or padded, copied
    t_flatten: float = 0.0  # prepare state to a DeviceIndex, ell_host read
    t_slice: float = 0.0    # the tree build's host state cut into sub-trees
    bytes_to_host: int = 0
    bytes_to_device: int = 0

    @property
    def t_total(self) -> float:
        return self.t_vertical + self.t_prepare + self.t_build


@dataclasses.dataclass
class AppendReport:
    """Accounting for one incremental append (build only the affected
    sub-trees, reuse every untouched leaf segment)."""

    n_old: int = 0             # |S_old| real symbols
    n_new: int = 0             # |S_new| real symbols
    b_star: int = 0            # start of the terminal-affected suffix tail
    n_prefixes: int = 0        # sub-trees in the merged index
    n_affected: int = 0        # sub-trees rebuilt
    leaves_rebuilt: int = 0
    leaves_reused: int = 0
    t_scan: float = 0.0        # terminal-affected boundary scan (queries)
    partition_fallback: bool = False  # delta changed the split structure
    t_partition: float = 0.0
    t_prepare: float = 0.0     # elastic-range loop over affected groups
    t_merge: float = 0.0

    @property
    def t_total(self) -> float:
        return self.t_scan + self.t_partition + self.t_prepare + self.t_merge

    @property
    def reuse_frac(self) -> float:
        total = self.leaves_rebuilt + self.leaves_reused
        return self.leaves_reused / total if total else 0.0


def _terminal_affected_start(count_fn, s_new: np.ndarray, n_old_real: int,
                             max_plen: int, batch: int = 64) -> int:
    """First position ``b*`` of the terminal-affected suffix tail.

    Replacing the old terminal with appended symbols can only reorder a
    sub-tree if some pair of its suffixes used to diverge AT the old
    terminal — i.e. the later suffix's whole tail ``S_old[b:]`` occurs at
    least twice in ``S_old``.  That predicate is suffix-closed, so the
    affected positions form one contiguous range ``[b*, n_old_real)``
    found by a backward scan of count queries against the OLD index, a
    batch of ``batch`` tails a query.  Tails longer than the index's
    ``max_pattern_len`` are checked on their truncated prefix: count < 2
    there proves the full tail unique, count >= 2 is treated as affected
    (conservative, never unsound).
    """
    cap = max(4, max_plen // 4 * 4)  # stays under pad_batch's width check
    b = n_old_real - 1
    while b >= 0:
        bs = list(range(b, max(b - batch, -1), -1))
        pats = [np.asarray(s_new[bb:min(n_old_real, bb + cap)],
                           np.int32) for bb in bs]
        counts = count_fn(pats)
        for bb, c in zip(bs, counts):
            if int(c) < 2:
                return bb + 1
        b -= batch
    return 0


# the serial engine's per-prefix builders (``repro.core.api._BUILDERS``):
# host numpy, the scan's stack walk and the Cartesian-tree build, the last
# two on the indexer's device
_BUILDERS = {
    "numpy": lambda ell, b, n, dev: build_mod.build_numpy(ell, b, n),
    "scan": lambda ell, b, n, dev: build_mod.build_scan(ell, b, n, dev),
    "parallel": lambda ell, b, n, dev: build_mod.build_parallel(
        torch.from_numpy(ell).to(dev), torch.from_numpy(b).to(dev), n),
}


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


def _flatten_state(groups, states, copies=None):
    """(prefixes, freqs, ell) in sorted prefix order from a final (G, F)
    prepare state: ``ell`` is one gather on the state's device, indexed
    by a flat index built there with ``repeat_interleave``.  ``copies``
    (a ``BuildReport``) counts the two int64 segment vectors sent there
    (leave it out for a state on the host)."""
    with obs.tracer().span("flatten/segments") as sp:
        entries = _sorted_segments(groups)
        f_cap = states.L.shape[1]
        dev = states.L.device
        freq = torch.tensor([e[3] for e in entries], dtype=torch.int64,
                            device=dev)
        seg = torch.tensor([e[1] * f_cap + e[2] for e in entries],
                           dtype=torch.int64, device=dev)
        first = torch.cumsum(freq, 0) - freq
        total = int(freq.sum())
        flat_idx = (torch.repeat_interleave(seg - first, freq)
                    + torch.arange(total, device=dev))
        ell = states.L.reshape(-1)[flat_idx]
        prefixes = [e[0] for e in entries]
        freqs = np.array([e[3] for e in entries], np.int32)
        sp.set(subtrees=len(entries), bytes=freq.nbytes + seg.nbytes)
    if copies is not None:
        copies.bytes_to_device += freq.nbytes + seg.nbytes
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
        if config.build_impl not in (*_BUILDERS, "none"):
            raise ValueError(
                f"unknown build_impl {config.build_impl!r}; "
                f"choose one of {sorted((*_BUILDERS, 'none'))}")
        if config.node_lcp not in ("state", "words"):
            raise ValueError(
                f"unknown node_lcp {config.node_lcp!r}; "
                "choose 'state' or 'words'")
        self.device = kops.resolve_device(device)

    def partition(self, s: np.ndarray, report: BuildReport | None = None):
        """Vertical partitioning + grouping (the master-node phase)."""
        cfg = self.config
        vstats = report.vertical if report else VerticalStats()
        t0 = time.perf_counter()
        with obs.tracer().span("build/vertical", n=len(s),
                               f_max=cfg.f_max) as sp:
            groups = vertical_partition_grouped(
                s,
                base=self.alphabet.base,
                f_max=cfg.f_max,
                strategy=cfg.vertical_strategy,
                group=cfg.group,
                stats=vstats,
                device=self.device,
                copies=report,
            )
            sp.set(groups=len(groups))
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

    def _device_text(self, s: np.ndarray, report: BuildReport | None = None):
        """The device-resident string for construction reads: the dense
        :class:`packing.PackedText` or the terminal-padded byte string, per
        ``EraConfig.packing``; construction output is identical.  The dense
        words are packed where they live (the real codes copied once, the
        span's ``where="device"`` on a card), the byte string is padded on
        the host and copied once: ``report`` takes the time (``t_text``)
        and the bytes copied."""
        t0 = time.perf_counter()
        dense = packing.resolve_dense(self.config.packing, self.alphabet)
        on_card = dense and self.device.type == "cuda"
        with obs.tracer().span("build/text",
                               currency="dense" if dense else "byte",
                               where="device" if on_card else "host") as sp:
            if dense:
                text = packing.pack_text(s, self.alphabet,
                                         extra=2 * self.config.w_max + 8,
                                         device=self.device)
                copied = len(s) - 1  # the real codes, not the words
            else:
                text = self._pad(s)
                copied = text.nbytes
            sp.set(bytes=copied)
        if report is not None:
            report.t_text = time.perf_counter() - t0
            report.bytes_to_device += copied
        return text

    def _prepare_batched(self, s: np.ndarray, report: BuildReport):
        """partition → padded (G, F) batched prepare, timing into ``report``.
        Returns (groups, states, s_padded); states is None without groups."""
        groups = self.partition(s, report)
        if not groups:
            return groups, None, None
        capacity = self._capacity(groups)
        report.capacity = capacity
        s_padded = self._device_text(s, report)
        t0 = time.perf_counter()
        states = subtree_prepare_batch(s_padded, groups, capacity,
                                       self.config.elastic_config(),
                                       report.prepare,
                                       sort_fuse=self.config.sort_fuse,
                                       compact=self.config.compaction,
                                       copies=report)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        report.t_prepare = time.perf_counter() - t0
        return groups, states, s_padded

    # ---- sub-tree builds ---------------------------------------------------

    def process_group(self, s_text, group, capacity: int,
                      pstats: PrepareStats | None = None,
                      group_index: int | None = None) -> list[SubTree]:
        """SubTreePrepare + slicing for ONE virtual tree (the serial
        engine's unit, ``repro.core.api.EraIndexer.process_group``)."""
        state = subtree_prepare(s_text, group, capacity,
                                self.config.elastic_config(), pstats,
                                group_index=group_index)
        return self._slice_subtrees(_HostState(state), group)

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
        with obs.tracer().span("build/total", n=len(s),
                               engine=self.config.construction):
            if self.config.construction == "batched":
                return self._build_batched(s, report)
            return self._build_serial(s, report)

    def _build_serial(self, s: np.ndarray,
                      report: BuildReport) -> SuffixTreeIndex:
        """The paper's serial engine (``repro.core.api._build_serial``):
        each group's own elastic loop, one after another, then each
        sub-tree's nodes from ``build_impl``'s builder."""
        groups = self.partition(s, report)
        capacity = self._capacity(groups)
        report.capacity = capacity
        s_text = self._device_text(s, report)

        t0 = time.perf_counter()
        subtrees: dict[tuple, SubTree] = {}
        for g_i, g in enumerate(groups):
            for st in self.process_group(s_text, g, capacity, report.prepare,
                                         group_index=g_i):
                subtrees[st.prefix] = st
        report.t_prepare = time.perf_counter() - t0

        t0 = time.perf_counter()
        if self.config.build_impl != "none":
            builder = _BUILDERS[self.config.build_impl]
            for st in subtrees.values():
                st.nodes = builder(st.ell.astype(np.int32),
                                   st.b_off.astype(np.int32), len(s),
                                   self.device)
        report.t_build = time.perf_counter() - t0
        return SuffixTreeIndex(s=np.asarray(s), alphabet=self.alphabet,
                               subtrees=subtrees, device=self.device)

    def _build_batched(self, s: np.ndarray,
                       report: BuildReport) -> SuffixTreeIndex:
        groups, states, s_text = self._prepare_batched(s, report)
        subtrees: dict[tuple, SubTree] = {}
        if states is not None:
            t0 = time.perf_counter()
            with obs.tracer().span("build/slice") as sp:
                host = _HostState(states)
                for g_i, g in enumerate(groups):
                    for st in self._slice_subtrees(host.group(g_i), g):
                        subtrees[st.prefix] = st
                sp.set(subtrees=len(subtrees), bytes=host.nbytes)
            report.t_slice = time.perf_counter() - t0
            report.t_prepare += report.t_slice
            report.bytes_to_host += host.nbytes

            t0 = time.perf_counter()
            if self.config.build_impl != "none":
                with obs.tracer().span("build/nodes",
                                       subtrees=len(subtrees),
                                       node_lcp=self.config.node_lcp):
                    self._attach_nodes_batched(states, groups, subtrees,
                                               len(s), copies=report,
                                               s_text=s_text)
            report.t_build = time.perf_counter() - t0
        return SuffixTreeIndex(s=np.asarray(s), alphabet=self.alphabet,
                               subtrees=subtrees, device=self.device)

    def _attach_nodes_batched(self, states, groups, subtrees, n_total: int,
                              *, copies: BuildReport,
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
        ``b_off``; the node sets are identical.  ``copies`` counts the
        rows' index and mask sent and the node sets read back.
        """
        use_words = self.config.node_lcp == "words" and s_text is not None
        tracer = obs.tracer()
        entries = _sorted_segments(groups)
        f_cap = states.L.shape[1]
        dev = states.L.device
        flat_L = states.L.reshape(-1)
        flat_b = states.b_off.reshape(-1)
        fill_hist = obs.metrics().histogram(
            "build_bucket_fill_ratio",
            buckets=(0.1, 0.25, 0.5, 0.75, 0.9, 1.0),
            help="real cells / padded cells per node-build bucket "
                 "(low = the pow2 padding is wasting batched work)")
        for f_pad, rows in build_mod.bucket_pad_widths(
                [e[3] for e in entries]):
            fill = 0.0
            if obs.metrics_enabled() or obs.trace_enabled():
                real_cells = sum(entries[e_i][3] for e_i in rows)
                fill = real_cells / (len(rows) * f_pad)
                fill_hist.observe(fill)
            with tracer.span("build/node_bucket", f_pad=f_pad,
                             rows=len(rows), fill=round(fill, 4)):
                with tracer.span("nodes/rows") as sp:
                    idx = np.zeros((len(rows), f_pad), np.int64)
                    mask = np.zeros((len(rows), f_pad), bool)
                    for r, e_i in enumerate(rows):
                        freq = entries[e_i][3]
                        idx[r, :freq] = _entry_flat_idx(entries[e_i], f_cap)
                        mask[r, :freq] = True
                    sp.set(bytes=idx.nbytes + mask.nbytes)
                    copies.bytes_to_device += idx.nbytes + mask.nbytes
                    idx = torch.from_numpy(idx).to(dev)
                    mask = torch.from_numpy(mask).to(dev)
                    ell_rows = torch.where(mask, flat_L[idx], n_total)
                with tracer.span("nodes/lcp", words=use_words):
                    if use_words:
                        boff_rows = build_mod.boff_rows_from_text(
                            s_text, ell_rows, n_total)
                    else:
                        boff_rows = torch.where(mask, flat_b[idx], 0)
                del idx, mask
                with tracer.span("nodes/cartesian"):
                    nodes = build_mod.build_parallel_batch(
                        ell_rows, boff_rows, n_total)
                with tracer.span("nodes/extract") as sp:
                    moved = copies.bytes_to_host + copies.bytes_to_device
                    compact = build_mod.unpad_nodes_rows(
                        nodes, [entries[e_i][3] for e_i in rows], copies)
                    for e_i, node_set in zip(rows, compact):
                        subtrees[entries[e_i][0]].nodes = node_set
                    sp.set(bytes=copies.bytes_to_host
                           + copies.bytes_to_device - moved)

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

        With the batched engine the leaf arrays go straight from the
        (G, F) prepare state into suffix-array order with one device
        gather — no per-prefix sub-tree dict and no node build.  The
        serial engine builds the full index first and flattens it.
        ``device_kwargs``: ``route_cap``, ``max_pattern_len``,
        ``packing`` (defaults to the config's).
        """
        from repro_torch.core.query import DeviceIndex  # local: import cycle

        report = report if report is not None else BuildReport(
            VerticalStats(), PrepareStats())
        device_kwargs.setdefault("packing", self.config.packing)
        if self.config.construction != "batched":
            return self.build(s, report).to_device(**device_kwargs)
        with obs.tracer().build_span("build/device", n=len(s)):
            groups, states, _ = self._prepare_batched(s, report)
            if states is None:
                raise ValueError("cannot flatten an empty index")
            t0 = time.perf_counter()
            with obs.tracer().span("build/flatten"):
                prefixes, freqs, ell = _flatten_state(groups, states, report)
                del states
                dev = DeviceIndex.from_prepare(
                    alphabet=self.alphabet,
                    s=np.asarray(s),
                    prefixes=prefixes,
                    freqs=freqs,
                    ell=ell,
                    device=self.device,
                    copies=report,
                    **device_kwargs,
                )
            report.t_flatten = time.perf_counter() - t0
        return dev


    def build_stream(self, s: np.ndarray, report: BuildReport | None = None,
                     *, device_budget: int | None = None,
                     overlap: bool = True,
                     stream_report: StreamReport | None = None,
                     **device_kwargs):
        """String → :class:`repro_torch.core.query.DeviceIndex` through the
        out-of-core streaming pipeline
        (:func:`repro_torch.core.prepare.subtree_prepare_stream`): the
        groups run in chunks whose double-buffered state fits
        ``device_budget`` bytes, the host→device copy of chunk k+1 behind
        the elastic loop of chunk k (``overlap``).  The index equals
        :meth:`build_device`'s.  Returns ``(index, stream_report)``."""
        from repro_torch.core.query import DeviceIndex  # local: import cycle

        report = report if report is not None else BuildReport(
            VerticalStats(), PrepareStats())
        device_kwargs.setdefault("packing", self.config.packing)
        with obs.tracer().build_span("build/stream", n=len(s)):
            groups = self.partition(s, report)
            if not groups:
                raise ValueError("cannot flatten an empty index")
            capacity = self._capacity(groups)
            report.capacity = capacity
            s_text = self._device_text(s, report)
            t0 = time.perf_counter()
            states, srep = subtree_prepare_stream(
                s_text, groups, capacity, self.config.elastic_config(),
                device_budget=device_budget, overlap=overlap,
                stats=report.prepare, report=stream_report,
                sort_fuse=self.config.sort_fuse,
                compact=self.config.compaction, copies=report)
            report.t_prepare = time.perf_counter() - t0  # the drain synced
            del s_text
            t0 = time.perf_counter()
            with obs.tracer().span("build/flatten"):
                # the drained state is on the host: its segments cost no copy
                prefixes, freqs, ell = _flatten_state(groups, states)
                del states
                dev = DeviceIndex.from_prepare(
                    alphabet=self.alphabet, s=np.asarray(s),
                    prefixes=prefixes, freqs=freqs, ell=ell,
                    device=self.device, copies=report, **device_kwargs)
            report.t_flatten = time.perf_counter() - t0
        return dev, srep

    # ---- incremental append ------------------------------------------------

    def _incremental_partition(self, s_new: np.ndarray, old_prefixes,
                               old_freqs, old_offs, old_ell,
                               n_old_real: int):
        """``s_new``'s vertical-partition prefix table from the OLD flat
        tables, rescanning only the dirty window tail
        (``repro.core.api.EraIndexer._incremental_partition``).

        A window position's owning prefix depends on at most
        ``max_prefix_len`` symbols, so only positions in
        ``[n_old_real - max_prefix_len + 1, n_new_real]`` can change
        ownership or create occurrences.  Each dirty position walks the
        old prefix trie under S_new: landing on a member prefix bumps its
        count; falling off the trie creates a new survivor.  Old
        occurrence lists come from the flat index (a sub-tree's ``ell``
        segment IS its position set).  A member whose updated count
        overflows ``f_max`` splits locally on the next symbol.  Returns
        ``(table, dirty_flags)`` — the :class:`SubTreePrefix` list and
        whether each sub-tree's leaf SET changed — or ``(None, None)``
        when an old expanded node drops back to ``f_max`` or below (the
        full scan would re-merge it), the one delta the local view cannot
        decide.
        """
        base = self.alphabet.base
        terminal = base - 1
        f_max = self.config.f_max
        n_new_real = len(s_new) - 1
        old_syms = [tuple(int(c) for c in p) for p in old_prefixes]
        max_plen = max(len(p) for p in old_syms)
        dirty_lo = max(0, n_old_real - max_plen + 1)

        members = set(old_syms)
        interior: set[tuple] = set()
        for p in old_syms:
            for t in range(1, len(p)):
                interior.add(p[:t])

        pad = np.full(max_plen + 2, terminal, np.uint8)
        sp = np.concatenate([np.asarray(s_new, np.uint8), pad])
        owned: dict[tuple, list[int]] = {}
        new_members: set[tuple] = set()
        for b in range(dirty_lo, n_new_real + 1):
            p: tuple = ()
            for t in range(max_plen + 1):
                p = p + (int(sp[b + t]),)
                if p in members or p in new_members:
                    owned.setdefault(p, []).append(b)
                    break
                if p in interior:
                    continue
                # first node off the old trie: the zero-frequency branch
                # the full scan would now keep as a fresh survivor
                new_members.add(p)
                owned.setdefault(p, []).append(b)
                break
            else:  # deeper than every old prefix: structure changed
                return None, None

        s_arr = np.asarray(s_new, np.uint8)

        def _next_sym(pos: np.ndarray, t: int) -> np.ndarray:
            """Symbol t past each position, the terminal beyond the end."""
            idx = pos + t
            sym = np.full(pos.size, terminal, np.int64)
            inside = idx < s_arr.size
            sym[inside] = s_arr[idx[inside]]
            return sym

        table: list[SubTreePrefix] = []
        dirty_flags: list[bool] = []
        interior_freq: dict[tuple, int] = {}
        pending: list[tuple[tuple, np.ndarray]] = []  # overflows to split

        def _account(p: tuple, freq: int) -> None:
            for t in range(1, len(p)):
                q = p[:t]
                interior_freq[q] = interior_freq.get(q, 0) + freq

        for p, f, o in zip(old_syms, old_freqs, old_offs):
            seg = old_ell[int(o):int(o) + int(f)]
            lost = int((seg >= dirty_lo).sum())
            gained = owned.get(p, ())
            freq = int(f) - lost + len(gained)
            _account(p, freq)
            if freq == 0:
                continue                   # every occurrence moved away
            if lost or gained:
                keep = seg[seg < dirty_lo].astype(np.int64)
                pos = np.sort(np.concatenate(
                    [keep, np.asarray(gained, np.int64)]))
                if freq > f_max:
                    pending.append((p, pos))
                    continue
                table.append(SubTreePrefix(symbols=p, freq=freq,
                                           positions=pos))
                dirty_flags.append(True)
            else:
                table.append(SubTreePrefix(symbols=p, freq=freq,
                                           positions=seg.astype(np.int64)))
                dirty_flags.append(False)
        for p in sorted(new_members):
            pos = np.asarray(owned[p], np.int64)
            _account(p, int(pos.size))
            if pos.size > f_max:
                pending.append((p, pos))
                continue
            table.append(SubTreePrefix(symbols=p, freq=int(pos.size),
                                       positions=pos))
            dirty_flags.append(True)
        # every node the old scan expanded must still overflow, else the
        # full scan would KEEP it instead of its children
        if any(f <= f_max for f in interior_freq.values()):
            return None, None
        # local refinement of overflowing sub-trees (vertical phase 2 on
        # the merged position lists; masks keep positions ascending)
        while pending:
            p, pos = pending.pop()
            if pos.size == 0:
                continue
            if pos.size <= f_max:
                table.append(SubTreePrefix(symbols=p, freq=int(pos.size),
                                           positions=pos))
                dirty_flags.append(True)
                continue
            nxt = _next_sym(pos, len(p))
            for c in range(base):
                child = pos[nxt == c]
                if child.size:
                    pending.append((p + (c,), child))
        return table, dirty_flags

    def _append_merge(self, s_new: np.ndarray, old_prefixes, old_freqs,
                      old_offs, old_ell, count_fn, max_plen: int,
                      arep: AppendReport):
        """The append engine: rebuild only the affected sub-trees of
        ``s_new`` and reuse every other leaf segment of the old flat
        layout (``repro.core.api.EraIndexer._append_merge``).

        A sub-tree of the new partition is affected iff its prefix is new
        or its occurrence count changed, its prefix holds the terminal, or
        it owns a suffix in the terminal-affected tail ``[b*,
        n_old_real)`` (:func:`_terminal_affected_start`).  Every other
        sub-tree keeps its leaf set and its order, so its old ``ell``
        segment is reused verbatim and the merged index equals a full
        rebuild.  The affected groups run :func:`subtree_prepare_batch`
        on the indexer's device.  Returns ``(prefixes, freqs, ell)``.
        """
        terminal = self.alphabet.base - 1
        n_old_real = int(np.asarray(old_freqs, np.int64).sum()) - 1
        n_new_real = len(s_new) - 1
        if int(s_new[-1]) != terminal:
            raise ValueError("appended string must end with the terminal")
        if n_new_real <= n_old_real:
            raise ValueError(
                f"append needs new symbols: |S_new|={n_new_real} real "
                f"symbols vs |S_old|={n_old_real}")
        arep.n_old = n_old_real
        arep.n_new = n_new_real

        t0 = time.perf_counter()
        b_star = _terminal_affected_start(count_fn, s_new, n_old_real,
                                          max_plen)
        arep.b_star = b_star
        arep.t_scan = time.perf_counter() - t0

        t0 = time.perf_counter()
        table, dirty_flags = self._incremental_partition(
            s_new, old_prefixes, old_freqs, old_offs, old_ell, n_old_real)
        if table is None:  # split structure changed: full scan (rare)
            arep.partition_fallback = True
            groups_new = self.partition(s_new)
            table = [p for g in groups_new for p in g.prefixes]
            for p in table:  # the partition leaves them on the device
                p.positions = p.positions.cpu().numpy()
            dirty_flags = None
        arep.t_partition = time.perf_counter() - t0

        old_map = {p: (int(f), int(o))
                   for p, f, o in zip(old_prefixes, old_freqs, old_offs)}
        affected = []
        with obs.tracer().span("append/classify", prefixes=len(table),
                               fallback=int(dirty_flags is None)) as sp:
            for i, p in enumerate(table):
                old = old_map.get(p.symbols)
                in_tail = lambda: bool(((p.positions >= b_star)
                                        & (p.positions < n_old_real)).any())
                if dirty_flags is not None:
                    # incremental table: leaf-set changes are already
                    # flagged; an unchanged set still rebuilds when any
                    # suffix lies in the terminal-comparison tail
                    changed = dirty_flags[i]
                    if not changed and in_tail():
                        p.positions = np.sort(p.positions)
                        changed = True
                else:
                    changed = (old is None or old[0] != p.freq
                               or terminal in p.symbols or in_tail())
                if changed:
                    affected.append(p)
            sp.set(affected=len(affected), b_star=b_star)
        arep.n_prefixes = len(table)
        arep.n_affected = len(affected)

        rebuilt: dict[tuple, np.ndarray] = {}
        if affected:
            t0 = time.perf_counter()
            re_groups = group_prefixes(affected, self.config.f_max)
            capacity = min(self.config.f_max,
                           max(g.total_freq for g in re_groups))
            s_text = self._device_text(s_new)
            with obs.tracer().span("append/prepare",
                                   groups=len(re_groups),
                                   subtrees=len(affected)):
                states = subtree_prepare_batch(
                    s_text, re_groups, capacity,
                    self.config.elastic_config(),
                    sort_fuse=self.config.sort_fuse,
                    compact=self.config.compaction)
            del s_text
            L_host = states.L.cpu().numpy()
            del states
            for g_i, g in enumerate(re_groups):
                for (off, freq), p in zip(segments_of(g), g.prefixes):
                    rebuilt[p.symbols] = L_host[g_i, off:off + freq]
            arep.t_prepare = time.perf_counter() - t0

        t0 = time.perf_counter()
        order = sorted(range(len(table)), key=lambda i: table[i].symbols)
        segs, pref_out, freq_out = [], [], []
        reused = 0
        for i in order:
            p = table[i]
            seg = rebuilt.get(p.symbols)
            if seg is None:
                f, o = old_map[p.symbols]
                seg = old_ell[o:o + f]
                reused += f
            segs.append(np.asarray(seg, np.int32))
            pref_out.append(p.symbols)
            freq_out.append(p.freq)
        ell = np.concatenate(segs).astype(np.int32)
        arep.leaves_reused = reused
        arep.leaves_rebuilt = int(ell.size) - reused
        arep.t_merge = time.perf_counter() - t0
        return pref_out, np.asarray(freq_out, np.int32), ell

    @staticmethod
    def _check_append_prefix(old_codes: np.ndarray, s_new: np.ndarray,
                             n_old_real: int) -> None:
        if not np.array_equal(np.asarray(s_new[:n_old_real], np.uint8),
                              np.asarray(old_codes[:n_old_real], np.uint8)):
            raise ValueError(
                "append requires S_new to extend the indexed string: the "
                f"first {n_old_real} symbols differ")

    def append_device(self, dev, s_new: np.ndarray,
                      report: AppendReport | None = None, **device_kwargs):
        """Extend a :class:`repro_torch.core.query.DeviceIndex` over
        ``S_old`` to index ``s_new`` (S_old's real symbols + appended
        symbols + terminal) without a full rebuild: only the affected
        sub-trees run the elastic loop (:meth:`_append_merge`), the
        terminal-tail scan counts through ``dev.find_batch_ranges`` (one
        search launch a batch), and every other leaf segment is copied
        from the old index.  The result equals ``build_device(s_new)``
        with the same flatten kwargs and carries ``epoch = dev.epoch + 1``
        so serving caches flush.  Returns ``(index, append_report)``."""
        from repro_torch.core.query import DeviceIndex  # local: import cycle

        s_new = np.asarray(s_new)
        arep = report if report is not None else AppendReport()
        plen = dev.sub_plen.cpu().numpy()
        pref = dev.sub_prefix.cpu().numpy()
        old_prefixes = [tuple(int(c) for c in pref[t, :plen[t]])
                        for t in range(len(plen))]
        old_freqs = dev.sub_freq.cpu().numpy()
        old_offs = dev.sub_off.cpu().numpy()
        self._check_append_prefix(dev.string_codes(), s_new,
                                  int(old_freqs.sum()) - 1)

        def count_fn(pats):
            padded, lengths, route = dev.pad_batch(pats)
            _, cnt = dev.find_batch_ranges(padded, lengths, route)
            return cnt.cpu().numpy()

        with obs.tracer().span("append/total", n_old=dev.n_leaves - 1,
                               n_new=len(s_new) - 1):
            prefixes, freqs, ell = self._append_merge(
                s_new, old_prefixes, old_freqs, old_offs, dev.ell_host,
                count_fn, dev.max_pattern_len, arep)
            device_kwargs.setdefault("packing", self.config.packing)
            device_kwargs.setdefault("max_pattern_len", dev.max_pattern_len)
            device_kwargs.setdefault("epoch", dev.epoch + 1)
            device_kwargs.setdefault("device", self.device)
            new_dev = DeviceIndex.from_prepare(
                alphabet=self.alphabet, s=s_new, prefixes=prefixes,
                freqs=freqs, ell=ell, **device_kwargs)
        return new_dev, arep

    def append_sharded(self, sharded, s_new: np.ndarray,
                       report: AppendReport | None = None, *,
                       n_shards: int | None = None, **device_kwargs):
        """Incremental append for a
        :class:`repro_torch.core.fabric.ShardedIndex`
        (``repro.core.api.EraIndexer.append_sharded``): the route-ordered
        per-shard tables concatenate into the single-device flat layout
        (``ShardedIndex.flat_table``), :meth:`_append_merge` runs there
        (its terminal-tail scan counts through ``sharded.find_batch``), and
        the merged layout re-shards through
        :meth:`ShardedIndex.from_flat` over the old index's mesh, into
        ``n_shards`` shards (default: as many as before).  The result
        carries ``epoch + 1``.  Returns ``(sharded_index, append_report)``."""
        from repro_torch.core import fabric  # local: import cycle

        s_new = np.asarray(s_new)
        arep = report if report is not None else AppendReport()
        old_prefixes, old_freqs, old_ell = sharded.flat_table()
        old_offs = np.concatenate(
            [[0], np.cumsum(old_freqs)[:-1]]).astype(np.int64)
        self._check_append_prefix(sharded.string_codes(), s_new,
                                  int(old_freqs.sum()) - 1)

        def count_fn(pats):
            return np.asarray([len(h) for h in sharded.find_batch(pats)],
                              np.int64)

        with obs.tracer().span("append/total", n_old=sharded.n_leaves - 1,
                               n_new=len(s_new) - 1, shards=sharded.n_shards):
            prefixes, freqs, ell = self._append_merge(
                s_new, old_prefixes, old_freqs, old_offs, old_ell, count_fn,
                sharded.max_pattern_len, arep)
            device_kwargs.setdefault("packing", self.config.packing)
            device_kwargs.setdefault("max_pattern_len",
                                     sharded.max_pattern_len)
            device_kwargs.setdefault("epoch", sharded.epoch + 1)
            device_kwargs.setdefault("device", self.device)
            device_kwargs.setdefault("mesh", sharded.mesh)
            new_idx = fabric.ShardedIndex.from_flat(
                alphabet=self.alphabet, s=s_new, prefixes=prefixes,
                freqs=freqs, ell=ell, n_shards=n_shards or sharded.n_shards,
                **device_kwargs)
        return new_idx, arep

    def build_sharded(self, s: np.ndarray, n_shards: int | None = None,
                      report: BuildReport | None = None, *,
                      mesh=None, sort_fuse: bool | None = None,
                      **device_kwargs):
        """String → :class:`repro_torch.core.fabric.ShardedIndex`
        (``repro.core.api.EraIndexer.build_sharded``): the partition and
        the text on the indexer's device, :func:`fabric.sharded_prepare`
        over ``mesh`` (default: every device of the indexer's type; a
        device may repeat), then the flattened leaf arrays cut by route
        key into ``n_shards`` shards (default: the mesh's size) placed
        over the same mesh.  The construction mesh and the shard count
        are independent.  Results equal :meth:`build_device`'s."""
        from repro_torch.core import fabric  # local: import cycle

        report = report if report is not None else BuildReport(
            VerticalStats(), PrepareStats())
        device_kwargs.setdefault("packing", self.config.packing)
        mesh = fabric.as_mesh(mesh, self.device)
        if n_shards is None:
            n_shards = len(mesh)
        groups = self.partition(s, report)
        if not groups:
            raise ValueError("cannot shard an empty index")
        capacity = self._capacity(groups)
        s_text = self._device_text(s)
        t0 = time.perf_counter()
        states = fabric.sharded_prepare(
            s_text, groups, capacity, self.config.elastic_config(),
            mesh=mesh, stats=report.prepare,
            sort_fuse=(sort_fuse if sort_fuse is not None
                       else self.config.sort_fuse))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        report.t_prepare = time.perf_counter() - t0
        del s_text
        prefixes, freqs, ell = _flatten_state(groups, states)
        del states
        return fabric.ShardedIndex.from_flat(
            alphabet=self.alphabet, s=np.asarray(s), prefixes=prefixes,
            freqs=freqs, ell=ell, n_shards=n_shards, mesh=mesh,
            device=self.device, **device_kwargs)


class _HostState:
    """One bulk device→host transfer of a (G, F) state (or one group's
    (F,) state), sliceable per group."""

    def __init__(self, states):
        self.L = states.L.cpu().numpy()
        self.b_off = states.b_off.cpu().numpy()
        self.b_c1 = states.b_c1.cpu().numpy()
        self.b_c2 = states.b_c2.cpu().numpy()

    @property
    def nbytes(self) -> int:
        return (self.L.nbytes + self.b_off.nbytes + self.b_c1.nbytes
                + self.b_c2.nbytes)

    def group(self, g_i: int) -> "_HostState":
        view = object.__new__(_HostState)
        view.L = self.L[g_i]
        view.b_off = self.b_off[g_i]
        view.b_c1 = self.b_c1[g_i]
        view.b_c2 = self.b_c2[g_i]
        return view

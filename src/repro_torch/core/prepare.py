"""SubTreePrepare (paper §4.2.2), the elastic-range batched engine — PyTorch port.

Counterpart of ``repro.core.prepare``.  Every virtual tree's leaf
positions are stacked into one padded (G, F) state; each iteration reads
``w`` symbols after every active leaf, sorts each group's rows stably with
the area id as the major key, detects divergence between adjacent rows,
and re-derives the areas with a cumulative-max segment sweep.  The text
decides the key currency, as in the JAX package:

* a dense :class:`packing.PackedText` — word keys: the
  ``range_gather_words`` kernel through :func:`packing.word_sort_keys`,
  divergence by XOR + clz on the dense words;
* the terminal-padded uint8 byte string — byte keys: the
  ``range_gather_pack`` kernel, an unsigned sort on the key words, and the
  ``lcp_pairs`` kernel on adjacent rows;
* a dense text under ``REPRO_WORD_COMPARE=byte`` (the byte-key oracle) —
  the byte branch on keys read from the dense words by the
  ``range_gather_packed`` kernel, equal to the byte string's keys.

Where the
JAX package ``vmap``s one group's step over G, this module writes the
batch dimension out: every tensor of the step is (G, F) and each sort runs
along dim 1, so groups never mix.

Exactness against the JAX package rests on two sort rules (hazard C2:
torch has no ``lexsort``):

* fused keys (:func:`_fused_sort_order`) pack (major, window, tie) into
  32-bit lanes exactly as the JAX code does; pairs of lanes become one
  int64 key whose signed order equals their unsigned order, and a chain
  of stable sorts (least significant key first) gives the lexsort's
  permutation;
* the unfused oracle sorts ``tie``, then the words in reverse, then the
  major key, each with a stable sort;
* the byte branch always takes the lexsort on (major, key words as
  unsigned) — the JAX package reads ``sort_fuse`` only in the word branch
  (hazard C7) — with adjacent 32-bit lanes paired into one int64 key.

The host loop reads back the per-group active counts once per iteration,
as the reference does; nothing else syncs.

:func:`subtree_prepare` is the paper's serial engine: one group's loop at
its own elastic range, the (1, F) case of the same step, sorting on the
oracle keys with no compaction, as the JAX package's per-group step does.

:func:`subtree_prepare_stream` is the out-of-core engine: the same loop
over contiguous chunks of groups sized to a device budget
(:func:`repro_torch.core.iomodel.plan_stream`), each chunk's state built
on the host and copied to the card on a side stream while the previous
chunk iterates; the result comes back to the host.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import iomodel, packing
from repro_torch.core.packing import MASK32, PackedText, to_u64
from repro_torch.core.vertical import VirtualTree
from repro_torch.kernels import ops as kops

DONE = -1


class PrepareState(NamedTuple):
    """(G, F) state of the batched engine, (F,) for one group's loop
    (:func:`subtree_prepare`); every field is int32."""

    L: torch.Tensor      # leaf positions (suffix offsets), -1 pad
    start: torch.Tensor  # symbols consumed so far per element
    area: torch.Tensor   # active-area id (= index of first element), -1 done
    b_off: torch.Tensor  # B offset, -1 undefined (b_*[:, 0] unused)
    b_c1: torch.Tensor   # first divergent symbol of left branch
    b_c2: torch.Tensor   # first divergent symbol of right branch


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """Memory-budget knobs (paper §4.4)."""

    r_budget_symbols: int = 1 << 20  # |R|: total symbols fetched per scan
    w_min: int = 4
    w_max: int = 256
    elastic: bool = True  # False = static range (paper Fig. 9b ablation)
    static_w: int = 16


def _init_arrays(groups: list[VirtualTree], capacity: int, device,
                 copies=None):
    """(L, start, area) as (G, capacity) int32 tensors on ``device``.

    Each prefix's segment gets its own initial area (id = segment start);
    frequency-1 prefixes are born resolved.  One scatter per field: the
    prefixes' positions are concatenated in group order and placed by a
    flat index built with ``repeat_interleave``.  The four per-segment
    vectors go to the device, and the positions too where they are not
    tensors already (the partition leaves them on the device); given
    ``copies`` (a ``BuildReport``) their bytes add to
    ``copies.bytes_to_device``.
    """
    g = len(groups)
    L = torch.full((g, capacity), -1, dtype=torch.int32, device=device)
    start = torch.zeros((g, capacity), dtype=torch.int32, device=device)
    area = torch.full((g, capacity), -1, dtype=torch.int32, device=device)
    seg_start, seg_freq, seg_len, seg_area, pos = [], [], [], [], []
    for g_i, group in enumerate(groups):
        total = group.total_freq
        if total > capacity:
            raise ValueError(f"group frequency {total} exceeds capacity {capacity}")
        off = 0
        for p in group.prefixes:
            seg_start.append(g_i * capacity + off)
            seg_freq.append(p.freq)
            seg_len.append(p.length)
            seg_area.append(off if p.freq > 1 else -1)
            if copies is not None and not isinstance(p.positions,
                                                     torch.Tensor):
                copies.bytes_to_device += np.asarray(p.positions).nbytes
            pos.append(torch.as_tensor(p.positions, device=device))
            off += p.freq
    if not pos:
        return L, start, area
    if copies is not None:  # int64 freq and start, int32 length and area
        copies.bytes_to_device += 24 * len(seg_freq)
    freq = torch.tensor(seg_freq, dtype=torch.int64, device=device)
    first = torch.cumsum(freq, 0) - freq           # segment start in ``pos``
    total = int(sum(seg_freq))
    rank = torch.arange(total, device=device) - torch.repeat_interleave(first, freq)
    base = torch.tensor(seg_start, dtype=torch.int64, device=device)
    flat = torch.repeat_interleave(base, freq) + rank
    L.view(-1)[flat] = torch.cat(pos).to(torch.int32)
    start.view(-1)[flat] = torch.repeat_interleave(
        torch.tensor(seg_len, dtype=torch.int32, device=device), freq)
    area.view(-1)[flat] = torch.repeat_interleave(
        torch.tensor(seg_area, dtype=torch.int32, device=device), freq)
    return L, start, area


def init_batch(groups: list[VirtualTree], capacity: int,
               device="cuda", copies=None) -> PrepareState:
    """Stack ALL groups into one padded (G, F) state for the batched engine
    (``copies``: see :func:`_init_arrays`)."""
    if not groups:
        raise ValueError("init_batch needs at least one group")
    dev = kops.resolve_device(device)
    L, start, area = _init_arrays(groups, capacity, dev, copies)
    shape = L.shape
    return PrepareState(
        L=L, start=start, area=area,
        b_off=torch.full(shape, -1, dtype=torch.int32, device=dev),
        b_c1=torch.zeros(shape, dtype=torch.int32, device=dev),
        b_c2=torch.zeros(shape, dtype=torch.int32, device=dev),
    )


def _host_init_batch(groups: list[VirtualTree], capacity: int,
                     pin: bool = False, copies=None) -> PrepareState:
    """The stacked (G, F) state built on the host — the unit the streaming
    pipeline stages for its host→device copies; ``pin`` builds it in
    page-locked memory, so those copies run asynchronously.  The fields
    are those of :func:`init_batch`; each prefix's segment is one slice
    write (a host copy), as in the JAX package's ``_init_arrays``.
    Positions held as tensors (on the device, from the partition) come to
    the host for it; given ``copies`` their bytes add to
    ``copies.bytes_to_host``."""
    if not groups:
        raise ValueError("init_batch needs at least one group")
    shape = (len(groups), capacity)
    kw = dict(dtype=torch.int32, pin_memory=pin)
    state = PrepareState(L=torch.full(shape, -1, **kw),
                         start=torch.zeros(shape, **kw),
                         area=torch.full(shape, -1, **kw),
                         b_off=torch.full(shape, -1, **kw),
                         b_c1=torch.zeros(shape, **kw),
                         b_c2=torch.zeros(shape, **kw))
    L, start, area = (t.numpy() for t in state[:3])
    for g_i, group in enumerate(groups):
        if group.total_freq > capacity:
            raise ValueError(f"group frequency {group.total_freq} exceeds "
                             f"capacity {capacity}")
        off = 0
        for p in group.prefixes:
            f = p.freq
            pos = p.positions
            if isinstance(pos, torch.Tensor):
                pos = pos.cpu().numpy()
                if copies is not None:
                    copies.bytes_to_host += pos.nbytes
            L[g_i, off:off + f] = pos
            start[g_i, off:off + f] = p.length
            if f > 1:
                area[g_i, off:off + f] = off
            off += f
    return state


def _signed_pair(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Two unsigned 32-bit lanes (int64) as ONE int64 whose signed order
    is the lexicographic unsigned order of (hi, lo)."""
    return (hi - (1 << 31)) * (1 << 32) + lo


def _pair_lanes(lanes: list[torch.Tensor]) -> list[torch.Tensor]:
    """Unsigned 32-bit lanes (int64, most significant first) → int64 keys
    of two lanes each, whose lexicographic order is the lanes'."""
    if len(lanes) % 2:
        lanes = lanes + [torch.zeros_like(lanes[0])]
    return [_signed_pair(lanes[i], lanes[i + 1])
            for i in range(0, len(lanes), 2)]


def _stable_order(keys: list[torch.Tensor]) -> torch.Tensor:
    """Row-wise (dim 1) stable lexicographic order of (G, F) int64 keys,
    most significant first: a chain of stable sorts, least significant
    key first — the permutation ``jnp.lexsort`` gives per row."""
    order = None
    for key in reversed(keys):
        k = key if order is None else torch.gather(key, 1, order)
        step = torch.sort(k, dim=1, stable=True).indices
        order = step if order is None else torch.gather(order, 1, step)
    return order


def _fused_sort_order(major, keys, tie, *, w: int, bits: int,
                      f: int) -> torch.Tensor | None:
    """Stable row-wise sort order on (major, window, tie) packed into the
    fewest 32-bit lanes, exactly as ``repro.core.prepare._fused_sort_order``
    packs them; the lanes are then sorted as int64 pairs.

    Returns None when the packing cannot beat the oracle sort (major + tie
    alone overflow one lane)."""
    mb = max(1, int(np.ceil(np.log2(max(f, 2)))))
    tb = max(1, int(np.ceil(np.log2(w + 2))))
    if mb + tb > 32:
        return None
    kw = w * bits
    total = mb + kw + tb
    n_lanes = -(-total // 32)
    lanes = [torch.zeros(major.shape, dtype=torch.int64, device=major.device)
             for _ in range(n_lanes)]

    def place(value, pos, width):
        # OR a right-aligned ``width``-bit field into the conceptual
        # bitstring at MSB-offset ``pos`` (lane bitrange [32j, 32j+32));
        # the mask keeps the 32-bit truncation of the uint32 original
        end = pos + width
        lane0, lane1 = pos // 32, (end - 1) // 32
        if lane0 == lane1:
            lanes[lane0] |= (value << (32 * (lane0 + 1) - end)) & MASK32
        else:  # field straddles a lane boundary: split high/low
            lanes[lane0] |= value >> (end - 32 * (lane0 + 1))
            lanes[lane1] |= (value << (32 * (lane1 + 1) - end)) & MASK32

    place(major.to(torch.int64), 0, mb)
    for j in range(keys.shape[-1]):
        m_j = min(32, kw - 32 * j)  # meaningful top bits of word j
        place(to_u64(keys[..., j]) >> (32 - m_j), mb + 32 * j, m_j)
    place(tie.to(torch.int64), mb + kw, tb)
    return _stable_order(_pair_lanes(lanes))


def _word_step(pt: PackedText, state: PrepareState, offs, major, active, *,
               w: int, sort_fuse: bool):
    """Steps 1-3 on dense word keys: (L, start, lcp, c1, c2) in sorted
    order."""
    g, f = state.L.shape
    # 1. read the dense word keys (range_gather_words kernel on the card);
    #    inactive rows come back zero from the gather itself
    flat_active = active.reshape(-1)
    keys, tie = packing.word_sort_keys(
        pt, offs.reshape(-1), w,
        gather_words=lambda p, o, w_: kops.gather_words(
            p, o, w_, mask=flat_active))
    nw = keys.shape[1]
    keys = keys.view(g, f, nw)
    tie = torch.where(active, tie.view(g, f), 0)

    # 2. segmented stable sort; the tiebreak lane is the least significant
    order = None
    if sort_fuse:
        order = _fused_sort_order(major, keys, tie, w=w, bits=pt.bits, f=f)
    if order is None:
        order = _stable_order([major.to(torch.int64)]
                              + [to_u64(keys[..., j]) for j in range(nw)]
                              + [tie.to(torch.int64)])
    L = torch.gather(state.L, 1, order)
    start = torch.gather(state.start, 1, order)
    keys = torch.gather(keys, 1, order[..., None].expand(g, f, nw))

    # 3. adjacent divergence: XOR + clz + terminal-limit rules
    lim = packing.word_limit(pt.n_real, L + start, w)
    prev_rows = torch.cat([keys[:, :1], keys[:, :-1]], dim=1)
    prev_lim = torch.cat([lim[:, :1], lim[:, :-1]], dim=1)
    lcp, c1, c2 = packing.lcp_adjacent_words(
        prev_rows, keys, prev_lim, lim, w, pt.bits, pt.terminal)
    return L, start, lcp, c1, c2


def _byte_step(text, state: PrepareState, offs, major, active, *, w: int):
    """Steps 1-3 on byte keys: (L, start, lcp, c1, c2) in sorted order."""
    g, f = state.L.shape
    # 1. read w symbols after every active leaf (range_gather_pack kernel on
    #    the byte string, range_gather_packed on a dense text); inactive
    #    rows are zero
    keys = kops.range_gather(text, offs.reshape(-1), w,
                             mask=active.reshape(-1))
    nw = keys.shape[1]
    keys = keys.view(g, f, nw)

    # 2. segmented stable sort on (major, key words compared unsigned):
    #    byte codes >= 128 set bit 31 of a key word (hazard C5)
    order = _stable_order(_pair_lanes(
        [major.to(torch.int64)] + [to_u64(keys[..., j]) for j in range(nw)]))
    L = torch.gather(state.L, 1, order)
    start = torch.gather(state.start, 1, order)
    keys = torch.gather(keys, 1, order[..., None].expand(g, f, nw))

    # 3. adjacent divergence (lcp_pairs kernel on the card)
    prev_rows = torch.cat([keys[:, :1], keys[:, :-1]], dim=1)
    lcp, c1, c2 = kops.lcp_pairs(prev_rows.reshape(g * f, nw),
                                 keys.reshape(g * f, nw), w)
    return L, start, lcp.view(g, f), c1.view(g, f), c2.view(g, f)


def prepare_step(text, state: PrepareState, *, w: int,
                 sort_fuse: bool = False,
                 word_keys: bool | None = None
                 ) -> tuple[PrepareState, torch.Tensor]:
    """One elastic-range iteration of a (G, F) batch for static range ``w``
    (``repro.core.prepare.prepare_step``, batched).

    ``text``: a dense :class:`PackedText` (word keys; ``sort_fuse`` packs
    the sort lanes) or the terminal-padded uint8 byte string (byte keys;
    ``sort_fuse`` does not apply).  ``word_keys`` (default: the
    ``REPRO_WORD_COMPARE`` knob) False runs a dense text through the byte
    branch, the byte-key oracle.  Returns (new_state, n_active) with
    ``n_active`` int64[G] on the device.
    """
    g, f = state.L.shape
    dev = state.L.device
    iota = torch.arange(f, dtype=torch.int32, device=dev).expand(g, f)
    active = state.area >= 0

    offs = torch.where(active, state.L + state.start, 0)
    major = torch.where(active, state.area, iota)

    if word_keys is None:
        word_keys = kops._use_word_compare()
    if isinstance(text, PackedText) and word_keys:
        L, start, lcp, c1, c2 = _word_step(text, state, offs, major, active,
                                           w=w, sort_fuse=sort_fuse)
    else:
        L, start, lcp, c1, c2 = _byte_step(text, state, offs, major, active,
                                           w=w)

    area_prev = torch.roll(state.area, 1, dims=1)  # wraps within a group
    same_area = (state.area == area_prev) & active & (iota > 0)
    new_split = same_area & (lcp < w)
    b_off = torch.where(new_split, start + lcp, state.b_off)
    b_c1 = torch.where(new_split, c1, state.b_c1)
    b_c2 = torch.where(new_split, c2, state.b_c2)

    # 4. recompute areas: a run starts where the old area changes or a new
    #    split landed; singleton runs are done
    run_start = active & (
        (iota == 0)
        | (state.area != area_prev)
        | ~torch.roll(active, 1, dims=1)
        | new_split
    )
    seg = torch.cummax(torch.where(run_start, iota, -1), dim=1).values
    tail_true = torch.ones((g, 1), dtype=torch.bool, device=dev)
    nxt_start = torch.cat([run_start[:, 1:], tail_true], dim=1)
    nxt_active = torch.cat([active[:, 1:], ~tail_true], dim=1)
    right_bound = nxt_start | ~nxt_active
    singleton = run_start & right_bound
    area = torch.where(active & ~singleton, seg, DONE).to(torch.int32)

    # 5. elastic advance for survivors
    start = torch.where(area >= 0, start + w, start)

    new_state = PrepareState(L=L, start=start, area=area,
                             b_off=b_off.to(torch.int32),
                             b_c1=b_c1, b_c2=b_c2)
    return new_state, (area >= 0).sum(dim=1)


def compact_step_batch(text, states: PrepareState, *, f_prime: int,
                       w: int, sort_fuse: bool,
                       word_keys: bool | None = None):
    """One elastic iteration on only the ACTIVE rows of each group.

    Each group's active rows are gathered (ascending) into a (G, f_prime)
    buffer, :func:`prepare_step` runs there unchanged, and the results are
    scattered back with ``area`` translated through the gather index map
    both ways (see ``repro.core.prepare.compact_step_batch`` for why that
    is exact).  ``f_prime`` must be >= every group's active count.
    """
    g, f = states.area.shape
    dev = states.area.device
    active = states.area >= 0
    # batched ``nonzero(size=f_prime, fill_value=f)``: scatter each active
    # row's index to its rank; inactive rows land in a trash column
    rank = torch.cumsum(active, dim=1) - 1
    slot = torch.where(active, rank, f_prime)
    idx = torch.full((g, f_prime + 1), f, dtype=torch.int64, device=dev)
    idx.scatter_(1, slot, torch.arange(f, device=dev).expand(g, f))
    idx = idx[:, :f_prime].contiguous()
    valid = idx < f
    safe = torch.clamp(idx, max=f - 1)

    def take(x, fill):
        return torch.where(valid, torch.gather(x, 1, safe), fill)

    # run-start positions -> compacted positions (run starts are active)
    carea = torch.where(
        valid,
        torch.searchsorted(idx, torch.clamp(take(states.area, 0), min=0)
                           .to(torch.int64)).to(torch.int32),
        DONE).to(torch.int32)
    cst = PrepareState(L=take(states.L, -1), start=take(states.start, 0),
                       area=carea, b_off=take(states.b_off, -1),
                       b_c1=take(states.b_c1, 0), b_c2=take(states.b_c2, 0))
    new, _ = prepare_step(text, cst, w=w, sort_fuse=sort_fuse,
                          word_keys=word_keys)
    # compacted run starts -> full-layout positions
    narea = torch.where(
        new.area >= 0,
        torch.gather(idx, 1, torch.clamp(new.area, min=0).to(torch.int64))
        .to(torch.int32), DONE).to(torch.int32)
    scat = torch.where(valid, idx, f)  # padding goes to the trash column

    def put(full, vals):
        buf = torch.cat([full, full[:, :1]], dim=1)
        buf.scatter_(1, scat, vals.to(full.dtype))
        return buf[:, :f].contiguous()

    new_states = PrepareState(L=put(states.L, new.L),
                              start=put(states.start, new.start),
                              area=put(states.area, narea),
                              b_off=put(states.b_off, new.b_off),
                              b_c1=put(states.b_c1, new.b_c1),
                              b_c2=put(states.b_c2, new.b_c2))
    return new_states, (new_states.area >= 0).sum(dim=1)


def compaction_width(maxact: int, capacity: int) -> int | None:
    """The compacted row width for a global max active count (pow2 bucket),
    or None while compaction cannot beat the full-width step."""
    f_prime = max(32, 1 << max(maxact - 1, 0).bit_length())
    return None if f_prime * 2 > capacity else f_prime


def elastic_range(cfg: ElasticConfig, n_active: int) -> int:
    """range = |R| / |L'| (paper §4.4), bucketed to a power of two."""
    if not cfg.elastic:
        return max(4, (cfg.static_w + 3) // 4 * 4)
    w = max(cfg.w_min, min(cfg.w_max, cfg.r_budget_symbols // max(1, n_active)))
    return 1 << int(np.floor(np.log2(w)))


@dataclasses.dataclass
class PrepareStats:
    iterations: int = 0
    ranges: list = dataclasses.field(default_factory=list)
    active_history: list = dataclasses.field(default_factory=list)
    symbols_fetched: int = 0
    record_offsets: bool = False  # keep per-iteration offsets for iomodel
    offsets_history: list = dataclasses.field(default_factory=list)


def _record_prepare_metrics(group_iters: list, wall_s: float,
                            cfg: ElasticConfig) -> None:
    """Registry rows for one completed prepare run
    (``repro.core.prepare._record_prepare_metrics``): each group's elastic
    iterations (a histogram, so skew shows), the loop's wall time, the run
    count and the |R| budget."""
    if not obs.metrics_enabled():
        return
    m = obs.metrics()
    h = m.histogram("prepare_group_iterations",
                    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
                    help="elastic-range iterations until each virtual "
                         "tree converged")
    for it in group_iters:
        h.observe(it)
    m.counter("prepare_convergence_seconds_total",
              "wall time spent in elastic-range loops").inc(wall_s)
    m.counter("prepare_runs_total",
              "completed SubTreePrepare loops").inc()
    m.gauge("prepare_r_budget_symbols",
            "|R| read-buffer budget of the last run").set(
        cfg.r_budget_symbols)


def _record_offsets(stats: PrepareStats | None, state: PrepareState,
                    copies=None) -> None:
    """Append the read offsets of every active row (``L + start``, int64,
    in row order) when ``stats.record_offsets`` asks for them (a host
    read, counted into ``copies.bytes_to_host``)."""
    if stats is not None and stats.record_offsets:
        act = state.area >= 0
        offs = (state.L + state.start)[act].cpu().numpy()
        if copies is not None:
            copies.bytes_to_host += offs.nbytes
        stats.offsets_history.append(offs.astype(np.int64))


def init_state(group: VirtualTree, capacity: int,
               device="cuda") -> PrepareState:
    """One group's occurrence lists as padded (capacity,) state tensors
    (``repro.core.prepare.init_state``): each prefix's segment gets its
    own initial area, frequency-1 prefixes are born resolved."""
    return PrepareState(*(t[0] for t in init_batch([group], capacity,
                                                   device)))


def subtree_prepare(
    text,
    group: VirtualTree,
    capacity: int,
    cfg: ElasticConfig = ElasticConfig(),
    stats: PrepareStats | None = None,
    max_iters: int = 10_000,
    group_index: int | None = None,
) -> PrepareState:
    """Run SubTreePrepare to completion for ONE virtual tree — the paper's
    serial engine (``repro.core.prepare.subtree_prepare``), on the device
    that holds ``text``.

    The group's own elastic range drives every iteration.  Like the JAX
    package's per-group step, it sorts on the multi-lane oracle keys with
    no compaction, whatever ``EraConfig.sort_fuse`` / ``compaction`` say;
    ``REPRO_WORD_COMPARE=byte`` runs a dense text on byte keys.  The step
    is :func:`prepare_step` on a (1, F) state; the host reads the active
    count once per iteration.  Returns the (F,) state.
    """
    word_keys = kops._use_word_compare()
    state = PrepareState(*(t[None] for t in init_state(group, capacity,
                                                        text.device)))
    n_active = int((state.area >= 0).sum())
    it = 0
    t0 = time.perf_counter()
    with obs.tracer().span("prepare/group",
                           group=-1 if group_index is None else group_index,
                           capacity=capacity) as sp:
        while n_active > 0:
            w = elastic_range(cfg, n_active)
            if it >= max_iters:
                raise RuntimeError(
                    "SubTreePrepare failed to converge after "
                    f"{it} iterations: group="
                    f"{group_index if group_index is not None else '?'} "
                    f"({len(group.prefixes)} prefixes, "
                    f"total_freq={group.total_freq}), "
                    f"w={w}, n_active={n_active}")
            _record_offsets(stats, state)
            with obs.tracer().span("prepare/step", w=w, n_active=n_active):
                state, n_active_dev = prepare_step(text, state, w=w,
                                                   sort_fuse=False,
                                                   word_keys=word_keys)
            if stats is not None:
                stats.iterations += 1
                stats.ranges.append(w)
                stats.active_history.append(n_active)
                stats.symbols_fetched += n_active * w
            n_active = int(n_active_dev.cpu()[0])  # the one sync an iteration
            it += 1
        sp.set(iterations=it)
    _record_prepare_metrics([it], time.perf_counter() - t0, cfg)
    return PrepareState(*(t[0] for t in state))


def subtree_prepare_batch(
    text,
    groups: list[VirtualTree],
    capacity: int,
    cfg: ElasticConfig = ElasticConfig(),
    stats: PrepareStats | None = None,
    max_iters: int = 10_000,
    sort_fuse: bool | None = None,
    compact: bool | None = None,
    copies=None,
) -> PrepareState:
    """Run SubTreePrepare to completion for ALL virtual trees at once on
    the device that holds ``text`` (a dense :class:`PackedText` or the
    terminal-padded uint8 byte string, see :func:`prepare_step`).

    ``sort_fuse``/``compact`` default to the promoted engine (fused sort
    keys + tail compaction); ``REPRO_SORT=lexsort`` / ``REPRO_COMPACT=off``
    — or the explicit arguments — pin the oracle paths.  The elastic range
    is shared across the batch, keyed to the busiest group.
    ``REPRO_WORD_COMPARE=byte`` runs a dense text on byte keys (the
    oracle); the arrays are identical.  ``copies`` (a ``BuildReport``)
    counts the state's set-up copies (:func:`init_batch`).
    """
    word_keys = kops._use_word_compare()
    with obs.tracer().span("prepare/init", groups=len(groups),
                           capacity=capacity):
        states = init_batch(groups, capacity, text.device, copies)
        n_active = (states.area >= 0).sum(dim=1).cpu().numpy()
    if sort_fuse is None:
        sort_fuse = kops._use_sort_fuse()
    if compact is None:
        compact = kops._use_compaction()
    group_iters = np.zeros(len(groups), np.int64)
    it = 0
    t0 = time.perf_counter()
    with obs.tracer().span("prepare/batch_loop", groups=len(groups),
                           capacity=capacity) as sp:
        while int(n_active.max()) > 0:
            w = elastic_range(cfg, int(n_active.max()))
            if it >= max_iters:
                live = np.nonzero(n_active > 0)[0]
                detail = "; ".join(
                    f"group {g}: {len(groups[g].prefixes)} prefixes, "
                    f"total_freq={groups[g].total_freq}, "
                    f"n_active={int(n_active[g])}"
                    for g in live[:8])
                raise RuntimeError(
                    f"SubTreePrepare failed to converge after {it} "
                    f"iterations (w={w}, {len(live)}/{len(groups)} groups "
                    f"active): {detail}")
            _record_offsets(stats, states, copies)
            group_iters += n_active > 0
            f_prime = (compaction_width(int(n_active.max()), capacity)
                       if compact else None)
            with obs.tracer().span("prepare/step", w=w,
                                   n_active=int(n_active.sum()),
                                   groups_active=int((n_active > 0).sum()),
                                   f_prime=f_prime or capacity):
                if f_prime is not None:
                    states, n_active_dev = compact_step_batch(
                        text, states, f_prime=f_prime, w=w,
                        sort_fuse=sort_fuse, word_keys=word_keys)
                else:
                    states, n_active_dev = prepare_step(
                        text, states, w=w, sort_fuse=sort_fuse,
                        word_keys=word_keys)
            if stats is not None:
                total_active = int(n_active.sum())
                stats.iterations += 1
                stats.ranges.append(w)
                stats.active_history.append(total_active)
                stats.symbols_fetched += total_active * w
            n_active = n_active_dev.cpu().numpy()  # the one sync an iteration
            it += 1
        sp.set(iterations=it)
    _record_prepare_metrics(group_iters.tolist(), time.perf_counter() - t0,
                            cfg)
    return states


@dataclasses.dataclass
class StreamReport:
    """Accounting for one out-of-core streaming build (paper §4.1 scaled
    to device memory): how many chunks the planner cut, how much
    host→device traffic the pipeline moved, how long the copies took and
    how much of that was hidden behind the elastic-range loop of the
    previous chunk.  Every time is measured: a synchronous copy by the
    host's clock around the copy and its synchronize, a standby copy by a
    CUDA event pair around it on the side stream."""

    n_chunks: int = 0
    overlap: bool = True
    groups: int = 0
    iterations: int = 0            # summed over chunk loops
    bytes_copied: int = 0          # host->device state traffic
    copy_s: float = 0.0            # measured total copy time
    copy_hidden_s: float = 0.0     # standby copy time beyond its wait
    copy_wait_s: float = 0.0       # blocking wait on the standby copies
    chunk_iters: list = dataclasses.field(default_factory=list)

    @property
    def overlap_frac(self) -> float:
        """Fraction of host→device transfer hidden behind compute."""
        return self.copy_hidden_s / self.copy_s if self.copy_s > 0 else 0.0


def _state_nbytes(state: PrepareState) -> int:
    return sum(t.numel() * t.element_size() for t in state)


def subtree_prepare_stream(
    text,
    groups: list[VirtualTree],
    capacity: int,
    cfg: ElasticConfig = ElasticConfig(),
    *,
    plan: iomodel.StreamPlan | None = None,
    device_budget: int | None = None,
    overlap: bool = True,
    stats: PrepareStats | None = None,
    report: StreamReport | None = None,
    max_iters: int = 10_000,
    sort_fuse: bool | None = None,
    compact: bool | None = None,
    copies=None,
) -> tuple[PrepareState, StreamReport]:
    """Out-of-core SubTreePrepare: pipeline group chunks through a device
    memory budget with double-buffered host→device copies, on the device
    that holds ``text`` (``repro.core.prepare.subtree_prepare_stream``).

    The planner (:func:`repro_torch.core.iomodel.plan_stream`, or an
    explicit ``plan``) slices the groups into contiguous chunks whose
    double-buffered (G_chunk, F) state fits ``device_budget``.  Each chunk
    runs the loop of :func:`subtree_prepare_batch` on its own rows, the
    elastic range keyed to the chunk's busiest group.  A chunk's state is
    built on the host (page-locked on a card); chunk 0 is copied
    synchronously, and with ``overlap`` the copy of chunk k+1 starts on a
    side CUDA stream right after chunk k dispatches its first step, so it
    transfers behind the chunk's loop.  The compute stream waits on the
    side stream before chunk k+1 starts, and the staged tensors are
    recorded on the compute stream so the caching allocator does not hand
    their memory out early.  The loop reads ``n_active`` back once per
    iteration and syncs nothing else.  ``overlap=False`` copies each chunk
    synchronously.  On the CPU the same loop runs without streams or
    pinning, and a standby "copy" takes no time.

    Range choice never changes results (Fig. 9b), so the arrays equal the
    one-shot build's; only ``start`` may differ when the per-chunk range
    schedules diverge from the global one.  Returns ``(state, report)``:
    the full (G, F) :class:`PrepareState` as CPU tensors in the original
    group order, and the copy accounting (:class:`StreamReport`: the
    standby copies timed by CUDA events on the side stream, read once
    their wait has synchronized with them).  ``copies`` (a
    ``BuildReport``) counts the positions read for each chunk's host
    state, the state copies and the drains.
    """
    if not groups:
        raise ValueError("subtree_prepare_stream needs at least one group")
    if plan is None:
        plan = iomodel.plan_stream(len(groups), capacity,
                                   budget_bytes=device_budget,
                                   double_buffer=overlap)
    rep = report if report is not None else StreamReport()
    rep.n_chunks = plan.n_chunks
    rep.overlap = overlap
    rep.groups = len(groups)

    word_keys = kops._use_word_compare()
    if sort_fuse is None:
        sort_fuse = kops._use_sort_fuse()
    if compact is None:
        compact = kops._use_compaction()
    dev = text.device
    on_card = dev.type == "cuda"
    compute = torch.cuda.current_stream(dev) if on_card else None
    side = torch.cuda.Stream(dev) if on_card and overlap else None
    g_total = len(groups)
    out = PrepareState(*(torch.empty((g_total, capacity), dtype=torch.int32)
                         for _ in range(6)))
    chunks = list(plan.chunks)
    tracer = obs.tracer()

    def host_state(lo: int, hi: int) -> PrepareState:
        with tracer.span("stream/host_init", groups=hi - lo) as sp:
            host = _host_init_batch(groups[lo:hi], capacity, pin=on_card,
                                    copies=copies)
            if tracer.enabled:  # the int64 positions read to the host
                sp.set(bytes=8 * sum(g.total_freq for g in groups[lo:hi]))
        return host

    def copy_sync(host: PrepareState) -> PrepareState:
        nb = _state_nbytes(host)
        with tracer.span("stream/copy", bytes=nb):
            t = time.perf_counter()
            state = PrepareState(*(h.to(dev, non_blocking=True)
                                   for h in host))
            if on_card:
                compute.synchronize()
            rep.copy_s += time.perf_counter() - t
        rep.bytes_copied += nb
        if copies is not None:
            copies.bytes_to_device += nb
        return state

    def copy_async(host: PrepareState):
        """Start the standby copy; returns (staged state, start event,
        done event), the events timing the copy on the side stream."""
        if not on_card:
            return host, None, None
        with torch.cuda.stream(side):
            start = torch.cuda.Event(enable_timing=True)
            start.record(side)
            staged = PrepareState(*(h.to(dev, non_blocking=True)
                                    for h in host))
            done = torch.cuda.Event(enable_timing=True)
            done.record(side)
        return staged, start, done

    group_iters = np.zeros(g_total, np.int64)
    t0 = time.perf_counter()
    with tracer.span("stream/pipeline", chunks=plan.n_chunks,
                     groups=g_total, capacity=capacity,
                     overlap=overlap) as sp_pipe:
        lo0, hi0 = chunks[0]
        states = copy_sync(host_state(lo0, hi0))
        for ci, (lo, hi) in enumerate(chunks):
            nxt = chunks[ci + 1] if ci + 1 < len(chunks) else None
            host_next = host_state(*nxt) if nxt is not None else None
            standby = None
            t_issue, issuer = 0, None
            n_active = (states.area >= 0).sum(dim=1).cpu().numpy()
            it = 0
            with tracer.span("stream/chunk", chunk=ci,
                             groups=hi - lo) as sp:
                while int(n_active.max()) > 0:
                    w = elastic_range(cfg, int(n_active.max()))
                    if it >= max_iters:
                        raise RuntimeError(
                            f"SubTreePrepare (stream chunk {ci}, groups "
                            f"[{lo}, {hi})) failed to converge after {it} "
                            f"iterations (w={w})")
                    group_iters[lo:hi] += n_active > 0
                    f_prime = (compaction_width(int(n_active.max()),
                                                capacity)
                               if compact else None)
                    with tracer.span(
                            "prepare/step", w=w,
                            n_active=int(n_active.sum()),
                            groups_active=int((n_active > 0).sum()),
                            f_prime=f_prime or capacity):
                        if f_prime is not None:
                            states, n_active_dev = compact_step_batch(
                                text, states, f_prime=f_prime, w=w,
                                sort_fuse=sort_fuse, word_keys=word_keys)
                        else:
                            states, n_active_dev = prepare_step(
                                text, states, w=w, sort_fuse=sort_fuse,
                                word_keys=word_keys)
                    if overlap and standby is None and host_next is not None:
                        # the step above is queued on the compute stream:
                        # the standby copy transfers behind the chunk's loop
                        t_issue = time.perf_counter_ns()
                        issuer = tracer.current()
                        standby = copy_async(host_next)
                    if stats is not None:
                        total_active = int(n_active.sum())
                        stats.iterations += 1
                        stats.ranges.append(w)
                        stats.active_history.append(total_active)
                        stats.symbols_fetched += total_active * w
                    n_active = n_active_dev.cpu().numpy()  # one sync a step
                    it += 1
                sp.set(iterations=it)
            rep.iterations += it
            rep.chunk_iters.append(it)
            # drain this chunk to its host slice (waits on the chunk's
            # compute stream, not on the standby copy)
            nb = _state_nbytes(states)
            with tracer.span("stream/drain", chunk=ci, bytes=nb):
                for o, d in zip(out, states):
                    o[lo:hi].copy_(d)
            if copies is not None:
                copies.bytes_to_host += nb
            if host_next is None:
                continue
            if standby is None:
                # synchronous mode, or a chunk that converged at init (no
                # step to hide the copy behind)
                states = copy_sync(host_next)
                continue
            nb = _state_nbytes(host_next)
            staged, start, done = standby
            t_wait = time.perf_counter()
            if on_card:
                done.synchronize()
                compute.wait_stream(side)
                for t in staged:
                    t.record_stream(compute)
            wait = time.perf_counter() - t_wait
            # both events have completed: reading them syncs nothing more
            copy = start.elapsed_time(done) / 1e3 if on_card else 0.0
            hidden = max(copy - wait, 0.0)
            states = staged
            rep.bytes_copied += nb
            if copies is not None:
                copies.bytes_to_device += nb
            rep.copy_s += copy
            rep.copy_wait_s += wait
            rep.copy_hidden_s += hidden
            tracer.complete(
                "stream/standby_copy", t_issue,
                time.perf_counter_ns() - t_issue, track="cuda/side_stream",
                parent=issuer, chunk=ci + 1, bytes=nb,
                copy_ms=round(copy * 1e3, 3), wait_ms=round(wait * 1e3, 3),
                hidden_frac=round(hidden / copy, 4) if copy > 0 else 0.0)
        sp_pipe.set(iterations=rep.iterations,
                    copy_ms=round(rep.copy_s * 1e3, 3),
                    hidden_ms=round(rep.copy_hidden_s * 1e3, 3),
                    overlap_frac=round(rep.overlap_frac, 4))
    _record_prepare_metrics(group_iters.tolist(), time.perf_counter() - t0,
                            cfg)
    return out, rep


def segments_of(group: VirtualTree) -> list[tuple[int, int]]:
    """(offset, length) of each prefix's slice in the packed state arrays."""
    segs = []
    off = 0
    for p in group.prefixes:
        segs.append((off, p.freq))
        off += p.freq
    return segs

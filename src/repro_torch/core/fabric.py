"""Sharded index fabric — PyTorch port of ``repro.core.fabric``.

ERA's shared-nothing parallel version (paper §7), in two halves, over a
**mesh**: a sequence of :class:`torch.device` in which shard ``k`` runs
on ``mesh[k % len(mesh)]``.  The whole fabric runs in one process, as
the JAX package's ``shard_map`` over a 1-D ``("shard",)`` mesh does.
:func:`fabric_mesh` gives the first ``n`` devices of a type; a mesh in
which a device repeats (``[torch.device("cuda", 0)] * 4``,
``[torch.device("cpu")] * 3``) is the caller's explicit choice and runs
several shards on one device, as JAX's
``--xla_force_host_platform_device_count`` does.  Every device of a mesh
has the build device's type: nothing falls back to another device.

**Sharded construction** (:func:`sharded_prepare`).  Virtual-tree groups
are independent, so the (G, F) elastic-range state splits along G into
contiguous per-shard blocks of ``ceil(G / n)`` groups (the last blocks
padded with born-converged groups), each on its mesh device beside one
copy of the build text per distinct device (replicated, as ``P()`` is).
Every iteration keys the range ``w`` and the compaction width to the
globally busiest group, the single-device schedule, so the states are
equal to :func:`repro_torch.core.prepare.subtree_prepare_batch`'s; a
shard steps only while it has active rows (a converged shard launches
nothing, the JAX ``lax.cond`` as a real skip).  The host reads the
shards' active counts once an iteration.

**ShardedIndex** — the flattened leaf arrays of
:class:`repro_torch.core.query.DeviceIndex` cut by the dense top-trie
route key into self-contained shards (one global ``k_route``, the full
string replicated), cut only between sub-trees whose depth-``k_route``
route intervals do not overlap, plus the host route→shard table.
``find_batch`` / ``find_fetch_batch`` split a batch by route key and run
each sub-batch against its owning shard alone (one search launch a
sub-batch); patterns shorter than ``k_route`` fan out to every shard
their route covers and the sorted position lists concatenate, so results
equal one DeviceIndex over the whole string.  Per-shard archives
(``{path}_shard{k}.npz``, the JAX package's layout) let each host of a
multi-host job warm-start its shard alone.
"""

from __future__ import annotations

import dataclasses
import glob
import re

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import packing as packing_mod
from repro_torch.core.prepare import (
    ElasticConfig,
    PrepareState,
    PrepareStats,
    compact_step_batch,
    compaction_width,
    elastic_range,
    init_batch,
    prepare_step,
)
from repro_torch.core.query import DeviceIndex, route_depth, shard_npz_path
from repro_torch.kernels import ops as kops


def fabric_mesh(n_shards: int | None = None,
                device="cuda") -> list[torch.device]:
    """The first ``n_shards`` devices of ``device``'s type (default: all
    of them); ``ValueError`` when there are fewer."""
    from repro_torch.launch.mesh import make_fabric_mesh
    return make_fabric_mesh(n_shards, device)


def as_mesh(mesh, device) -> list[torch.device]:
    """``mesh`` as a list of indexed devices, by default
    :func:`fabric_mesh` of ``device``'s type.  Every entry must have that
    type (``ValueError`` otherwise)."""
    kind = kops.resolve_device(device).type
    if mesh is None:
        return fabric_mesh(device=kind)
    out = []
    for d in mesh:
        d = kops.resolve_device(d)
        if d.type != kind:
            raise ValueError(f"mesh device {d} is not a {kind} device: a "
                             f"{kind} build shards over {kind} devices only")
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    if not out:
        raise ValueError("a mesh needs at least one device")
    return out


def _text_to(text, device: torch.device):
    """The build text (dense :class:`PackedText` or byte string) on
    ``device``; the same object when it is there already."""
    if isinstance(text, packing_mod.PackedText):
        if text.words.device == device:
            return text
        return dataclasses.replace(text, words=text.words.to(device))
    return text.to(device)


# ---- sharded construction --------------------------------------------------


def _pad_group_axis(states: PrepareState, g_pad: int) -> PrepareState:
    """Pad the G axis with born-converged dummy groups (area = -1
    everywhere, the JAX package's fill values) up to ``g_pad``."""
    g = states.L.shape[0]
    if g_pad == g:
        return states

    def pad(x, fill):
        extra = torch.full((g_pad - g,) + tuple(x.shape[1:]), fill,
                           dtype=x.dtype, device=x.device)
        return torch.cat([x, extra], dim=0)

    return PrepareState(L=pad(states.L, -1), start=pad(states.start, 0),
                        area=pad(states.area, -1), b_off=pad(states.b_off, -1),
                        b_c1=pad(states.b_c1, 0), b_c2=pad(states.b_c2, 0))


def _shard_state(groups, block: int, capacity: int,
                 device: torch.device) -> PrepareState:
    """One shard's (block, F) initial state on its device: its groups,
    then born-converged padding."""
    if groups:
        state = init_batch(groups, capacity, device)
    else:  # a mesh with more entries than groups: all padding
        state = PrepareState(*(torch.empty((0, capacity), dtype=torch.int32,
                                           device=device)
                               for _ in PrepareState._fields))
    return _pad_group_axis(state, block)


def sharded_prepare(
    text,
    groups,
    capacity: int,
    cfg: ElasticConfig = ElasticConfig(),
    *,
    mesh=None,
    stats: PrepareStats | None = None,
    max_iters: int = 10_000,
    sort_fuse: bool | None = None,
) -> PrepareState:
    """:func:`repro_torch.core.prepare.subtree_prepare_batch` over a mesh
    (``repro.core.fabric.sharded_prepare``): the groups in contiguous
    per-shard blocks, one step per live shard and elastic iteration.

    ``text`` lies on the build device; ``mesh`` (default: every device of
    its type) has that type.  Each iteration takes ``w`` and the
    compaction width ``f_prime`` from the global busiest group; a shard
    with active rows runs :func:`compact_step_batch` (``f_prime`` set) or
    :func:`prepare_step`, a converged shard nothing.  Compaction does not
    read ``REPRO_COMPACT`` (as in the JAX package); ``sort_fuse``
    defaults to ``REPRO_SORT``, the key currency to
    ``REPRO_WORD_COMPARE``.  Returns the final (G, F) state on the build
    device, the padding groups sliced off: equal to the single-device
    engine's.
    """
    build_dev = text.device
    devices = as_mesh(mesh, build_dev)
    n_shards = len(devices)
    g = len(groups)
    block = -(-g // n_shards)
    word_keys = kops._use_word_compare()
    if sort_fuse is None:
        sort_fuse = kops._use_sort_fuse()

    texts = {}  # one copy of the text per distinct mesh device
    for d in devices:
        if d not in texts:
            texts[d] = _text_to(text, d)
    states = [_shard_state(groups[k * block:(k + 1) * block], block,
                           capacity, devices[k]) for k in range(n_shards)]
    n_active = torch.cat([(st.area >= 0).sum(dim=1).to(build_dev)
                          for st in states]).cpu().numpy()
    it = 0
    with obs.tracer().span("fabric/shard_loop", groups=g, shards=n_shards,
                           capacity=capacity) as sp:
        while int(n_active.max()) > 0:
            # the GLOBAL busiest group keys the range and the compaction
            # width: the single-device schedule, step for step
            w = elastic_range(cfg, int(n_active.max()))
            if it >= max_iters:
                raise RuntimeError(
                    f"sharded SubTreePrepare failed to converge after {it} "
                    f"iterations (w={w}, "
                    f"{int((n_active > 0).sum())}/{g} groups active)")
            f_prime = compaction_width(int(n_active.max()), capacity)
            live = [k for k in range(n_shards)
                    if n_active[k * block:(k + 1) * block].max() > 0]
            counts = []
            with obs.tracer().span("fabric/step", w=w,
                                   n_active=int(n_active.sum()),
                                   shards_active=len(live),
                                   f_prime=f_prime or capacity):
                for k in live:
                    txt = texts[devices[k]]
                    if f_prime is not None:
                        states[k], cnt = compact_step_batch(
                            txt, states[k], f_prime=f_prime, w=w,
                            sort_fuse=sort_fuse, word_keys=word_keys)
                    else:
                        states[k], cnt = prepare_step(txt, states[k], w=w,
                                                      sort_fuse=sort_fuse,
                                                      word_keys=word_keys)
                    counts.append(cnt.to(build_dev, non_blocking=True))
            if stats is not None:
                total_active = int(n_active.sum())
                stats.iterations += 1
                stats.ranges.append(w)
                stats.active_history.append(total_active)
                stats.symbols_fetched += total_active * w
            got = torch.cat(counts).cpu().numpy()  # the one sync an iteration
            for j, k in enumerate(live):
                n_active[k * block:(k + 1) * block] = got[j * block:
                                                          (j + 1) * block]
            it += 1
        sp.set(iterations=it)
    # gather the blocks on the build device a field at a time, freeing
    # each shard's field as it goes (the peak holds one extra field)
    cols = [list(st) for st in states]
    del states
    out = []
    for i in range(len(PrepareState._fields)):
        parts = [c[i].to(build_dev) for c in cols]
        for c in cols:
            c[i] = None
        full = parts[0] if len(parts) == 1 else torch.cat(parts)
        del parts
        out.append(full[:g])
    return PrepareState(*out)


# ---- shard planning --------------------------------------------------------


def _entry_code_intervals(prefixes, base: int, k_route: int):
    """Per sub-tree depth-``k_route`` route-code interval [clo, chi] —
    the intervals ``DeviceIndex.from_prepare`` routes with."""
    clo = np.zeros(len(prefixes), np.int64)
    chi = np.zeros(len(prefixes), np.int64)
    for t, p in enumerate(prefixes):
        kk = min(len(p), k_route)
        c = 0
        for j in range(kk):
            c = c * base + p[j]
        clo[t] = c * base ** (k_route - kk)
        chi[t] = clo[t] + base ** (k_route - kk) - 1
    return clo, chi


def plan_shards(prefixes, freqs, base: int, k_route: int,
                n_shards: int) -> list[slice]:
    """Split the sorted sub-tree list into ≤ ``n_shards`` contiguous,
    leaf-balanced chunks, cutting only where adjacent route intervals do
    not overlap (sub-trees deeper than ``k_route`` share a cell and stay
    on one shard).  Returns per-shard entry slices."""
    n = len(prefixes)
    if n_shards < 1:
        raise ValueError(f"n_shards={n_shards} must be >= 1")
    clo, chi = _entry_code_intervals(prefixes, base, k_route)
    # a legal cut AFTER entry t: the next entry starts a fresh route cell
    cuts = np.nonzero(chi[:-1] < clo[1:])[0] + 1  # entry indices
    cum = np.concatenate([[0], np.cumsum(np.asarray(freqs, np.int64))])
    total = cum[-1]
    bounds = [0]
    for k in range(1, n_shards):
        target = total * k // n_shards
        if not len(cuts):
            break
        j = int(np.argmin(np.abs(cum[cuts] - target)))
        cut = int(cuts[j])
        if cut > bounds[-1]:
            bounds.append(cut)
            cuts = cuts[cuts > cut]
    bounds.append(n)
    return [slice(a, b) for a, b in zip(bounds[:-1], bounds[1:])]


# ---- the sharded index -----------------------------------------------------


class ShardedIndex:
    """A :class:`DeviceIndex` per route-key shard + the host route→shard
    table.  Query results equal one DeviceIndex over the whole string.
    ``mesh`` is the device list the index was placed over (default: each
    shard's device); an append re-shards over it."""

    def __init__(self, shards: list[DeviceIndex], cell_lo: np.ndarray,
                 mesh=None):
        if not shards:
            raise ValueError("ShardedIndex needs at least one shard")
        self.shards = shards
        self.cell_lo = np.asarray(cell_lo, np.int64)  # first owned cell
        self.mesh = (list(mesh) if mesh is not None
                     else [d.device for d in shards])
        dev = shards[0]
        self.base = dev.base
        self.k_route = dev.k_route
        self.max_pattern_len = dev.max_pattern_len
        n_cells = self.base ** self.k_route
        # every cell's owning shard (cells before shard 0 resolve there
        # and simply miss)
        self.route2shard = (np.searchsorted(
            self.cell_lo, np.arange(n_cells, dtype=np.int64),
            side="right") - 1).clip(0).astype(np.int32)

    # ---- construction ------------------------------------------------------

    @classmethod
    def from_flat(cls, *, alphabet, s, prefixes, freqs, ell,
                  n_shards: int, route_cap: int = 1 << 18,
                  max_pattern_len: int = 512, packing: str = "auto",
                  place: bool | None = None, epoch: int = 0,
                  mesh=None, device="cuda") -> "ShardedIndex":
        """Build from flattened construction output (the inputs of
        :meth:`DeviceIndex.from_prepare`) split into ≤ ``n_shards``
        route-contiguous shards, each built on ``device``.  ``place``
        moves shard ``k`` to ``mesh[k % len(mesh)]`` (``mesh`` default:
        every device of ``device``'s type; ``place`` default: the mesh
        holds more than one distinct device)."""
        freqs = np.asarray(freqs, np.int32)
        max_plen = max(len(p) for p in prefixes)
        k_route = route_depth(alphabet.base, max_plen, route_cap)
        slices = plan_shards(prefixes, freqs, alphabet.base, k_route,
                             n_shards)
        offs = np.concatenate([[0], np.cumsum(freqs)]).astype(np.int64)
        build_dev = kops.resolve_device(device)
        devices = as_mesh(mesh, build_dev)
        if place is None:
            place = len(set(devices)) > 1
        ell = torch.as_tensor(ell)
        shards, cell_lo = [], []
        for k, sl in enumerate(slices):
            dev = DeviceIndex.from_prepare(
                alphabet=alphabet, s=s, prefixes=prefixes[sl],
                freqs=freqs[sl],
                ell=ell[int(offs[sl.start]):int(offs[sl.stop])],
                route_cap=route_cap, max_pattern_len=max_pattern_len,
                packing=packing, k_route=k_route, epoch=epoch,
                device=build_dev)
            if place:
                dev = _place_index(dev, devices[k % len(devices)])
            shards.append(dev)
            clo, _ = _entry_code_intervals(prefixes[sl.start:sl.start + 1],
                                           alphabet.base, k_route)
            cell_lo.append(int(clo[0]))
        return cls(shards, np.asarray(cell_lo, np.int64), mesh=devices)

    # ---- routing -----------------------------------------------------------

    def route_key(self, pattern):
        """Global cache key (route code, length, bytes) — the same on
        every shard because ``k_route`` is shared."""
        return self.shards[0].route_key(pattern)

    def shard_span(self, pattern) -> tuple[int, int]:
        """(lo, hi) inclusive shard range a pattern's route covers.
        Patterns of length >= k_route hit exactly one shard; shorter
        ones cover a cell interval that may cross a boundary."""
        arr = np.asarray(pattern, np.int32)
        kk = min(arr.size, self.k_route)
        c = 0
        for j in range(kk):
            c = c * self.base + int(arr[j])
        span = self.base ** (self.k_route - kk)
        c_lo = c * span
        lo = int(self.route2shard[c_lo])
        hi = int(self.route2shard[c_lo + span - 1])
        return lo, hi

    def _split_batch(self, patterns):
        """shard id → list of pattern indices (fan-out for short spans)."""
        per_shard: dict[int, list[int]] = {}
        for i, p in enumerate(patterns):
            lo, hi = self.shard_span(p)
            for k in range(lo, hi + 1):
                per_shard.setdefault(k, []).append(i)
        return per_shard

    # ---- queries -----------------------------------------------------------

    def find_batch(self, patterns) -> list[np.ndarray]:
        """Per-pattern sorted occurrence positions; each sub-batch runs
        only against its owning shard (one search launch)."""
        out: list = [None] * len(patterns)
        for k, idxs in sorted(self._split_batch(patterns).items()):
            with obs.tracer().span("fabric/find_batch", shard=k,
                                   rows=len(idxs)):
                hits = self.shards[k].find_batch([patterns[i] for i in idxs])
            for i, h in zip(idxs, hits):
                out[i] = h if out[i] is None else np.sort(
                    np.concatenate([out[i], h]))
        return out

    def find_fetch_batch(self, patterns, *, fetch: int = 32):
        """Positions + a (fetch,) window at the first suffix-array-order
        match.  Shards are route-ordered, so the first shard (ascending)
        with a hit owns the globally first match's window."""
        out: list = [None] * len(patterns)
        wins = np.full((len(patterns), fetch), -1, np.int32)
        filled = [False] * len(patterns)
        for k, idxs in sorted(self._split_batch(patterns).items()):
            with obs.tracer().span("fabric/find_fetch", shard=k,
                                   rows=len(idxs)):
                hits, win = self.shards[k].find_fetch_batch(
                    [patterns[i] for i in idxs], fetch=fetch)
            for j, i in enumerate(idxs):
                out[i] = hits[j] if out[i] is None else np.sort(
                    np.concatenate([out[i], hits[j]]))
                if not filled[i] and len(hits[j]):
                    wins[i] = win[j]
                    filled[i] = True
        return out, wins

    # ---- introspection -----------------------------------------------------

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def n_leaves(self) -> int:
        return sum(int(d.ell.shape[0]) for d in self.shards)

    @property
    def epoch(self) -> int:
        """Mutation generation (uniform across shards — every append
        rebuilds all shards from the merged flat layout)."""
        return self.shards[0].epoch

    @property
    def devices(self) -> list[torch.device]:
        """Each shard's device, in shard order."""
        return [d.device for d in self.shards]

    def flat_table(self):
        """The global flattened view ``(prefixes, freqs, ell)``: the
        per-shard tables concatenated in route order, exactly the layout
        :meth:`DeviceIndex.from_prepare` flattens (what the append merge
        consumes)."""
        prefixes: list[tuple] = []
        freq_parts, ell_parts = [], []
        for dev in self.shards:
            plen = dev.sub_plen.cpu().numpy()
            pref = dev.sub_prefix.cpu().numpy()
            prefixes += [tuple(int(c) for c in pref[t, :plen[t]])
                         for t in range(len(plen))]
            freq_parts.append(dev.sub_freq.cpu().numpy())
            ell_parts.append(dev.ell_host)
        return (prefixes, np.concatenate(freq_parts).astype(np.int32),
                np.concatenate(ell_parts).astype(np.int32))

    def string_codes(self) -> np.ndarray:
        # every shard replicates the FULL string, but a shard's own
        # n_leaves is only its leaf-slice count: |S| is the total
        sh0 = self.shards[0]
        n = self.n_leaves
        if sh0.packed:
            return packing_mod.unpack_text(sh0.s_text, n=n)
        return sh0.s_text[:n].cpu().numpy()

    def stats(self) -> dict:
        return {
            "shards": self.n_shards,
            "k_route": self.k_route,
            "leaves": [int(d.ell.shape[0]) for d in self.shards],
            "cell_lo": self.cell_lo.tolist(),
        }

    # ---- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        """One self-contained npz PER SHARD (``{path}_shard{k}.npz``) so
        each host of a multi-host job warm-starts its shard locally."""
        for k, dev in enumerate(self.shards):
            dev.save(shard_npz_path(path, k))

    @classmethod
    def shard_files(cls, path: str) -> list[str]:
        """The per-shard archives for ``path``, in shard order."""
        pat = shard_npz_path(path, 0).replace("_shard0.npz", "_shard*.npz")

        def shard_no(p):
            m = re.search(r"_shard(\d+)\.npz$", p)
            return int(m.group(1)) if m else -1
        return sorted((p for p in glob.glob(pat) if shard_no(p) >= 0),
                      key=shard_no)

    @classmethod
    def load(cls, path: str, device="cuda") -> "ShardedIndex":
        """Every shard archive of ``path`` onto ``device``; the route
        table comes back from each shard's first prefix."""
        files = cls.shard_files(path)
        if not files:
            raise FileNotFoundError(f"no shard archives match "
                                    f"{shard_npz_path(path, 0)!r} siblings")
        shards = [DeviceIndex.load(f, device=device) for f in files]
        cell_lo = []
        for dev in shards:
            plen = int(dev.sub_plen[0])
            prefix = tuple(int(c) for c in dev.sub_prefix[0, :plen].tolist())
            clo, _ = _entry_code_intervals([prefix], dev.base, dev.k_route)
            cell_lo.append(int(clo[0]))
        return cls(shards, np.asarray(cell_lo, np.int64))


def _place_index(dev: DeviceIndex, device: torch.device) -> DeviceIndex:
    """One shard's tensors on its mesh device: every tensor field and the
    dense words (the host mirror ``ell_host`` stays put)."""
    put = lambda x: x.to(device)
    return dataclasses.replace(
        dev, s_text=_text_to(dev.s_text, device), ell=put(dev.ell),
        sub_off=put(dev.sub_off), sub_freq=put(dev.sub_freq),
        sub_prefix=put(dev.sub_prefix), sub_plen=put(dev.sub_plen),
        win_lo=put(dev.win_lo), win_hi=put(dev.win_hi),
        pows=put(dev.pows), spans=put(dev.spans))

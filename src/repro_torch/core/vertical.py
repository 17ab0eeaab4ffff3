"""Vertical partitioning (paper §4.1, Alg. VerticalPartitioning), PyTorch port.

Counterpart of ``repro.core.vertical``: splits the suffix tree of ``S``
into sub-trees ``T_p`` indexed by variable-length S-prefixes ``p`` with
frequency ``0 < f_p <= F_M``, then packs them into virtual trees (groups)
by first-fit-decreasing.

The string is uploaded to ``device`` once.  Given ``copies`` (a
``BuildReport``), the partition adds the bytes it moves between host and
device to ``copies.bytes_to_device`` / ``copies.bytes_to_host``: the
string, and per depth the candidate codes and their counts and the
survivors' codes and position bounds.  Iteration ``t`` of the
``histogram`` strategy extends the rolling base-``|Σ|+1`` window codes of
every suffix by one symbol on the device and counts the candidate
prefixes:

* while ``base**t <= 2**16`` through the ``kmer_histogram`` kernel (on
  CUDA always the hand kernel, as a TPU run always took the Pallas one);
* beyond that by ``searchsorted`` + ``bincount`` against the sorted
  candidates — the JAX package's host numpy path, run with torch on the
  device where the codes already live.

Survivor positions come from ONE stable sort of the codes per iteration
(``torch.sort(stable=True)`` keeps each code's positions ascending, as the
JAX ``_PositionIndex`` does) and stay on the device as int64 tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels import ops as kops

_KERNEL_NBINS_MAX = 1 << 16  # kmer_histogram bin bound


@dataclasses.dataclass
class SubTreePrefix:
    """A vertical-partition unit: the sub-tree T_p for S-prefix ``p``."""

    symbols: tuple[int, ...]  # symbol codes of p
    freq: int
    positions: torch.Tensor  # int64 occurrence positions of p in S, ascending

    @property
    def length(self) -> int:
        return len(self.symbols)


@dataclasses.dataclass
class VirtualTree:
    """A group of sub-trees processed as one unit (shared scans of S)."""

    prefixes: list[SubTreePrefix]

    @property
    def total_freq(self) -> int:
        return sum(p.freq for p in self.prefixes)


@dataclasses.dataclass
class VerticalStats:
    scans: int = 0  # full passes over S (histogram iterations)
    refine_steps: int = 0  # position-refinement rounds
    bytes_scanned: int = 0  # modeled sequential I/O


def _window_codes(s_padded: torch.Tensor, n: int, t: int, base: int,
                  prev: torch.Tensor | None) -> torch.Tensor:
    """Rolling base-``base`` codes of all length-t windows starting at
    0..n-1 (int64).  Extends ``prev`` IN PLACE: callers drop the depth
    ``t - 1`` codes once the depth-``t`` ones exist, so the update saves
    one n-sized buffer."""
    if prev is None:
        codes = s_padded[:n].to(torch.int64)
        for j in range(1, t):
            codes = codes * base + s_padded[j:j + n]
        return codes
    return prev.mul_(base).add_(s_padded[t - 1:t - 1 + n])


def _candidate_counts(s_padded: torch.Tensor, codes: torch.Tensor, n: int,
                      t: int, base: int, cand: np.ndarray) -> np.ndarray:
    """Frequency of each candidate depth-``t`` prefix code (numpy, int32
    from the kernel's bins, else int64): the codes go to the device and
    one count each comes back."""
    if base**t <= _KERNEL_NBINS_MAX:
        hist = kops.kmer_histogram(s_padded[:n + max(t, 2)], n, t, base)
        idx = torch.as_tensor(cand, device=hist.device)
        return hist[idx].cpu().numpy()
    cand_t = torch.as_tensor(cand, device=codes.device)
    cand_sorted, order = torch.sort(cand_t)
    idx = torch.searchsorted(cand_sorted, codes)
    idx_clipped = torch.clamp(idx, max=len(cand) - 1)
    hit = cand_sorted[idx_clipped] == codes
    counts = torch.bincount(idx_clipped[hit], minlength=len(cand))
    freq = torch.zeros(len(cand), dtype=torch.int64, device=codes.device)
    freq[order] = counts  # map sorted index back to candidate order
    return freq.cpu().numpy()


class _PositionIndex:
    """One stable sort of the window codes, sliced per survivor."""

    def __init__(self, codes: torch.Tensor):
        self.sorted_codes, self.order = torch.sort(codes, stable=True)

    def positions_of(self, codes: list[int]) -> list[torch.Tensor]:
        """Ascending positions of each code, with one host sync for all:
        the codes go to the device, two int64 bounds each come back."""
        c = torch.as_tensor(codes, dtype=torch.int64,
                            device=self.sorted_codes.device)
        lo = torch.searchsorted(self.sorted_codes, c, side="left")
        hi = torch.searchsorted(self.sorted_codes, c, side="right")
        bounds = torch.stack([lo, hi], dim=1).cpu().tolist()
        return [self.order[a:b].clone() for a, b in bounds]


def vertical_partition(
    s: np.ndarray,
    base: int,
    f_max: int,
    *,
    strategy: str = "histogram",
    stats: VerticalStats | None = None,
    device="cuda",
    copies=None,
) -> list[SubTreePrefix]:
    """Alg. VerticalPartitioning lines 1–11: the sub-tree prefix set."""
    if f_max < 1:
        raise ValueError("f_max must be >= 1")
    dev = kops.resolve_device(device)
    n = len(s)
    t_max_code = int(63 // np.ceil(np.log2(base)))  # int64 overflow guard
    stats = stats if stats is not None else VerticalStats()

    # ---- phase 1: histogram scans (paper-faithful) -----------------------
    survivors: list[tuple[tuple[int, ...], int]] = []  # (symbols, freq)
    survivor_positions: dict[tuple[int, ...], torch.Tensor] = {}
    overflow: list[tuple[int, ...]] = []  # prefixes needing refinement

    terminal = base - 1  # terminal is the largest code; pad continues it
    pad = np.full(max(t_max_code, 2), terminal, dtype=np.uint8)
    tracer = obs.tracer()
    with tracer.span("vertical/upload") as sp:
        s_padded = torch.from_numpy(
            np.concatenate([np.asarray(s, np.uint8), pad])).to(dev)  # one upload
        sp.set(bytes=s_padded.nbytes)
    if copies is not None:
        copies.bytes_to_device += s_padded.nbytes

    if strategy == "histogram":
        work = [(c,) for c in range(base)]
        codes = None
        t = 0
        while work:
            t += 1
            if t > t_max_code:
                overflow.extend(work)
                break
            with tracer.span("vertical/count", t=t,
                             candidates=len(work)) as sp:
                codes = _window_codes(s_padded, n, t, base, codes)
                stats.scans += 1
                stats.bytes_scanned += n
                cand = np.array(
                    [sum(c * base ** (t - 1 - j) for j, c in enumerate(p))
                     for p in work],
                    dtype=np.int64,
                )
                freq_by_work = _candidate_counts(s_padded, codes, n, t, base,
                                                 cand)
                nxt: list[tuple[int, ...]] = []
                found: list[tuple[tuple[int, ...], int, int]] = []
                for w_i, p in enumerate(work):
                    f = int(freq_by_work[w_i])
                    if 0 < f <= f_max:
                        found.append((p, f, int(cand[w_i])))
                    elif f > f_max:
                        nxt.extend(p + (c,) for c in range(base))
                if found:  # one grouping pass per iteration
                    pos_index = _PositionIndex(codes)
                    positions = pos_index.positions_of(
                        [c for _, _, c in found])
                    del pos_index
                    for (p, f, _), pos in zip(found, positions):
                        survivors.append((p, f))
                        survivor_positions[p] = pos
                # candidate codes out and their counts back, then int64
                # survivor codes out and their (lo, hi) bounds back
                to_dev = cand.nbytes + 8 * len(found)
                to_host = freq_by_work.nbytes + 16 * len(found)
                sp.set(found=len(found), bytes=to_dev + to_host)
            if copies is not None:
                copies.bytes_to_device += to_dev
                copies.bytes_to_host += to_host
            work = nxt
        del codes
    else:
        overflow = [(c,) for c in range(base)]

    # ---- phase 2: position refinement (beyond-paper / overflow) ----------
    if overflow:
        with tracer.span("vertical/refine", prefixes=len(overflow)):
            pending: list[tuple[tuple[int, ...], torch.Tensor]] = []
            for p in overflow:
                t = len(p)
                if t == 1:
                    pos = torch.nonzero(s_padded[:n] == p[0]).flatten()
                else:
                    mask = torch.ones(n, dtype=torch.bool, device=dev)
                    for j, c in enumerate(p):
                        mask &= s_padded[j:j + n] == c
                    pos = torch.nonzero(mask).flatten()
                    stats.bytes_scanned += n
                pending.append((p, pos))
            while pending:
                stats.refine_steps += 1
                nxt_pending = []
                for p, pos in pending:
                    f = len(pos)
                    if f == 0:
                        continue
                    if f <= f_max:
                        survivors.append((p, f))
                        survivor_positions[p] = pos
                        continue
                    t = len(p)
                    nxt_sym = s_padded[pos + t]
                    for c in range(base):
                        child_pos = pos[nxt_sym == c]
                        if len(child_pos):
                            nxt_pending.append((p + (c,), child_pos))
                pending = nxt_pending

    return [
        SubTreePrefix(symbols=p, freq=f, positions=survivor_positions[p])
        for p, f in survivors
    ]


def group_prefixes(prefixes: list[SubTreePrefix], f_max: int) -> list[VirtualTree]:
    """Alg. VerticalPartitioning lines 12–22: first-fit-decreasing grouping."""
    todo = sorted(prefixes, key=lambda p: -p.freq)
    groups: list[VirtualTree] = []
    while todo:
        group = [todo.pop(0)]
        total = group[0].freq
        rest = []
        for p in todo:
            if total + p.freq <= f_max:
                group.append(p)
                total += p.freq
            else:
                rest.append(p)
        todo = rest
        groups.append(VirtualTree(prefixes=group))
    return groups


def vertical_partition_grouped(
    s: np.ndarray,
    base: int,
    f_max: int,
    *,
    strategy: str = "histogram",
    group: bool = True,
    stats: VerticalStats | None = None,
    device="cuda",
    copies=None,
) -> list[VirtualTree]:
    """Full vertical partitioning: prefix set + (optional) grouping."""
    prefixes = vertical_partition(s, base, f_max, strategy=strategy,
                                  stats=stats, device=device, copies=copies)
    with obs.tracer().span("vertical/group", prefixes=len(prefixes)):
        if group:
            return group_prefixes(prefixes, f_max)
        return [VirtualTree(prefixes=[p]) for p in prefixes]

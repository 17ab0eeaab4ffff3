"""I/O cost model (paper §4.4 and Figs. 9-10) and the streaming planner —
PyTorch port: a copy of the JAX package's numpy-only ``repro.core.iomodel``,
so the port imports nothing of it.

The paper's I/O accounting, analytically:

* ``model_prepare_io`` — one group's SubTreePrepare reads: full sequential
  scans (WaveFront discipline), scans that skip blocks with no active
  offset (the disk-seek heuristic, §4.4), and the symbols a gather fetches;
* ``amortization_factor`` — one stream shared by all sub-trees of a group.

The device-memory side: ``plan_stream`` slices the vertical-partition
groups into chunks whose double-buffered (G_chunk, F) state fits a device
budget, the unit :func:`repro_torch.core.prepare.subtree_prepare_stream`
pipelines through host memory.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class IoReport:
    iterations: int
    seq_bytes_full: int        # full sequential scans (WaveFront discipline)
    seq_bytes_skip: int        # with the block-skip heuristic
    gathered_symbols: int      # what the gather path actually fetches
    blocks_touched: int


def model_prepare_io(
    active_offsets: list[np.ndarray],
    ranges: list[int],
    n: int,
    block_bytes: int = 1 << 20,
) -> IoReport:
    """Model one group's SubTreePrepare I/O from its per-iteration state.

    ``active_offsets[t]`` = string offsets read at iteration t;
    ``ranges[t]`` = elastic range (symbols per offset) at iteration t.
    """
    seq_full = 0
    seq_skip = 0
    gathered = 0
    blocks_total = 0
    for offs, w in zip(active_offsets, ranges):
        seq_full += n
        if len(offs) == 0:
            continue
        gathered += len(offs) * w
        lo = offs // block_bytes
        hi = (offs + w - 1) // block_bytes
        # blocks covered by each read, then dedup across reads
        touched = set()
        for a, b in zip(lo.tolist(), hi.tolist()):
            touched.update(range(a, b + 1))
        blocks_total += len(touched)
        seq_skip += len(touched) * block_bytes
    return IoReport(
        iterations=len(ranges),
        seq_bytes_full=seq_full,
        seq_bytes_skip=min(seq_skip, seq_full),
        gathered_symbols=gathered,
        blocks_touched=blocks_total,
    )


def amortization_factor(n_prefixes: int, n_groups: int) -> float:
    """How many sub-trees share each scan of S thanks to virtual trees."""
    return n_prefixes / max(1, n_groups)


# ---------------------------------------------------------------------------
# Device-memory side of the model (paper §4.1: ERA sizes the construction
# unit to the memory budget; here the budget is *device* memory and the
# unit is a chunk of vertical-partition groups).

# One (group, leaf-slot) cell of PrepareState is six int32 fields:
# L, start, area, b_off, b_c1, b_c2.
STATE_FIELDS = 6
STATE_CELL_BYTES = STATE_FIELDS * 4


def state_bytes_per_group(capacity: int) -> int:
    """Device bytes of elastic-range state for one vertical-partition
    group at leaf capacity F (padded, so every group costs the same)."""
    return STATE_CELL_BYTES * capacity


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """How the streaming build slices the group list into device-sized
    chunks.

    ``chunks`` are contiguous ``[lo, hi)`` ranges over the *original* group
    order, so flattening results back into the one-shot layout is a plain
    concatenation.  ``buffers`` is 2 when the pipeline double-buffers (the
    standby chunk's state is resident while the active chunk iterates) and
    1 for the synchronous copy-then-compute mode.
    """

    chunks: tuple[tuple[int, int], ...]
    capacity: int
    budget_bytes: int | None       # None = unbounded -> one chunk
    buffers: int = 2
    reserved_bytes: int = 0        # string + misc resident device bytes

    @property
    def n_chunks(self) -> int:
        return len(self.chunks)

    @property
    def groups_per_chunk(self) -> int:
        return max((hi - lo) for lo, hi in self.chunks) if self.chunks else 0

    @property
    def chunk_state_bytes(self) -> int:
        """Worst-case device bytes of one chunk's PrepareState."""
        return self.groups_per_chunk * state_bytes_per_group(self.capacity)

    @property
    def peak_bytes(self) -> int:
        """Modeled peak device footprint: resident string + the active
        chunk's state + (when double-buffered) the standby chunk."""
        return self.reserved_bytes + self.buffers * self.chunk_state_bytes

    def describe(self) -> dict:
        return {
            "n_chunks": self.n_chunks,
            "groups_per_chunk": self.groups_per_chunk,
            "capacity": self.capacity,
            "chunk_state_bytes": self.chunk_state_bytes,
            "peak_bytes": self.peak_bytes,
            "budget_bytes": self.budget_bytes,
            "buffers": self.buffers,
        }


def plan_stream(
    n_groups: int,
    capacity: int,
    *,
    budget_bytes: int | None = None,
    reserved_bytes: int = 0,
    double_buffer: bool = True,
) -> StreamPlan:
    """Slice ``n_groups`` vertical-partition groups into contiguous chunks
    whose double-buffered PrepareState fits ``budget_bytes`` of device
    memory.

    ``reserved_bytes`` models device allocations that stay resident for
    the whole build (the packed string, routing tables) and is subtracted
    from the budget before sizing chunks.  Degenerate budgets are honored
    rather than rejected: an unbounded (``None``) or huge budget collapses
    to one chunk — the streaming build then *is* the one-shot batched
    build — and a budget too small for even one double-buffered group
    still yields one-group chunks (the floor of the planner; the model's
    ``peak_bytes`` then reports the overshoot honestly).
    """
    if n_groups <= 0:
        return StreamPlan(chunks=(), capacity=capacity,
                          budget_bytes=budget_bytes,
                          buffers=2 if double_buffer else 1,
                          reserved_bytes=reserved_bytes)
    buffers = 2 if double_buffer else 1
    per_group = state_bytes_per_group(capacity)
    if budget_bytes is None:
        gpc = n_groups
    else:
        avail = max(0, budget_bytes - reserved_bytes)
        gpc = max(1, min(n_groups, avail // (buffers * per_group)))
    chunks = tuple((lo, min(lo + gpc, n_groups))
                   for lo in range(0, n_groups, gpc))
    return StreamPlan(chunks=chunks, capacity=capacity,
                      budget_bytes=budget_bytes, buffers=buffers,
                      reserved_bytes=reserved_bytes)

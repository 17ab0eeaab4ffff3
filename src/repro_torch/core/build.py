"""BuildSubTree (paper §4.2.2) — from (L, B) to the suffix sub-tree.
PyTorch port of ``repro.core.build``.

Node layout is structure-of-arrays, as in the JAX package:

* ``parent[v]``  — parent node id (-1 for the sub-tree root)
* ``depth[v]``   — string depth (symbols from the global root to ``v``)
* ``witness[v]`` — a leaf position under ``v``; the edge label of
  ``(parent[v], v)`` is ``S[witness+depth[parent]] .. S[witness+depth[v]-1]``.

Leaves are ``0..F-1`` in lexicographic order; internal nodes are allocated
from ``F`` upward (at most ``F`` of them).

* :func:`build_numpy` — the paper's sequential stack builder (host numpy);
* :func:`build_parallel_batch` — the internal nodes of a sub-tree are the
  Cartesian-tree nodes of ``B_off``; parent links follow from
  all-nearest-smaller-values over a range-min sparse table
  (:mod:`repro_torch.core.rmq`).  Where the JAX package ``vmap``s one
  row's builder, the port writes the ``(P, F_pad)`` batch out: every
  tensor carries the row dimension and every table runs along the last
  one.  Rows are independent, so a bucket is built in row chunks under a
  byte budget (:data:`NODE_BUILD_BYTES`) with identical node sets;
* :func:`lcp_from_text` / :func:`boff_rows_from_text` — the divergence
  rows recomputed from the text (``EraConfig(node_lcp="words")``) through
  :func:`repro_torch.kernels.ops.suffix_lcp_pairs`, on the device.

* :func:`build_scan` — the same stack builder written as the JAX
  package's ``lax.scan``: a fixed-depth stack array and its pointer
  carried leaf by leaf, on the host; the serial engine's
  ``build_impl="scan"``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import rmq


class SubTreeNodes(NamedTuple):
    parent: np.ndarray | torch.Tensor   # int32[2F] (slot 2F-1 may be unused)
    depth: np.ndarray | torch.Tensor    # int32[2F]
    witness: np.ndarray | torch.Tensor  # int32[2F]
    n_nodes: int | np.ndarray | torch.Tensor  # leaves + internal nodes
    n_leaves: int


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def nodes_to_host(nodes: SubTreeNodes) -> SubTreeNodes:
    """A node set in host form, one transfer per field (no-op for numpy):
    consumers that walk the arrays element-wise convert once up front."""
    return SubTreeNodes(
        parent=_host(nodes.parent),
        depth=_host(nodes.depth),
        witness=_host(nodes.witness),
        n_nodes=int(nodes.n_nodes),
        n_leaves=int(nodes.n_leaves),
    )


# ---------------------------------------------------------------------------
# Faithful sequential builder (numpy, host) — Alg. BuildSubTree
# ---------------------------------------------------------------------------

def build_numpy(ell: np.ndarray, b_off: np.ndarray, n_total: int) -> SubTreeNodes:
    """``ell``: int leaf positions (lex order); ``b_off[i]``: divergence depth
    of leaves i-1, i (b_off[0] unused); ``n_total``: len(S) incl. terminal."""
    f = len(ell)
    cap = 2 * max(f, 1)
    parent = np.full(cap, -1, dtype=np.int32)
    depth = np.zeros(cap, dtype=np.int32)
    witness = np.full(cap, -1, dtype=np.int32)

    root = f  # internal ids from f; root is the first internal node
    n_internal = 1
    depth[root] = 0
    witness[root] = int(ell[0]) if f else -1

    if f == 0:
        return SubTreeNodes(parent, depth, witness, 1, 0)

    parent[0] = root
    depth[0] = n_total - int(ell[0])
    witness[0] = int(ell[0])
    stack = [root, 0]  # path of node ids, root at bottom

    for i in range(1, f):
        off = int(b_off[i])
        # pop while the stack-top *edge* is deeper than off
        last = -1
        while depth[stack[-1]] > off:
            last = stack.pop()
        top = stack[-1]
        if depth[top] == off:
            u = top
        else:
            # break edge (top -> last) at depth off
            t = f + n_internal
            n_internal += 1
            parent[t] = top
            depth[t] = off
            witness[t] = witness[last]
            parent[last] = t
            stack.append(t)
            u = t
        parent[i] = u
        depth[i] = n_total - int(ell[i])
        witness[i] = int(ell[i])
        stack.append(i)

    return SubTreeNodes(parent, depth, witness, f + n_internal, f)


# ---------------------------------------------------------------------------
# Faithful builder as the JAX package's scan (explicit fixed-depth stack)
# ---------------------------------------------------------------------------

def build_scan(ell, b_off, n_total: int, device=None) -> SubTreeNodes:
    """``repro.core.build.build_scan``: the carry of its ``lax.scan`` —
    the node arrays, a fixed-depth stack of ``f + 2`` slots, its pointer
    and the internal-node count — walked leaf by leaf on host copies of
    ``ell`` and ``b_off``, the inner pops the scan's ``while_loop``.  The
    arrays have the ``2f`` slots and ``-1`` fill of the JAX builder's and
    come back as int32 tensors on ``device`` (default: ``ell``'s, or the
    CPU); ``n_nodes`` is an int.  Not on any build's hot path."""
    if device is None:
        device = ell.device if isinstance(ell, torch.Tensor) else "cpu"
    ell = _host(ell).astype(np.int64).tolist()  # Python ints: a fast walk
    b_off = _host(b_off).astype(np.int64).tolist()
    f = len(ell)
    cap = 2 * f
    root = f
    parent = [-1] * cap
    depth = [0] * cap
    witness = [-1] * cap
    parent[0] = root
    depth[0] = n_total - ell[0]
    witness[root] = witness[0] = ell[0]
    stack = [-1] * (f + 2)
    stack[0], stack[1] = root, 0
    sp, n_int = 1, 1
    for i in range(1, f):
        off = b_off[i]
        last = -1
        while depth[stack[sp]] > off:  # the scan's inner while_loop
            last = stack[sp]
            sp -= 1
        top = stack[sp]
        u = top
        if depth[top] != off:  # break edge (top -> last) at depth off
            t = f + n_int
            parent[t] = top
            depth[t] = off
            witness[t] = witness[last]
            parent[last] = t
            sp += 1
            stack[sp] = t
            n_int += 1
            u = t
        parent[i] = u
        depth[i] = n_total - ell[i]
        witness[i] = ell[i]
        sp += 1
        stack[sp] = i
    return SubTreeNodes(*(torch.tensor(a, dtype=torch.int32, device=device)
                          for a in (parent, depth, witness)), f + n_int, f)


# ---------------------------------------------------------------------------
# Parallel Cartesian-tree builder over a (P, F) batch of rows
# ---------------------------------------------------------------------------

# Device bytes one chunk of rows may take: three (levels + 1)-deep int32
# tables per cell plus the outputs and the int64 temporaries of the
# nearest-smaller-value searches (_CELL_TEMP_BYTES).
NODE_BUILD_BYTES = 12 << 30
_CELL_TEMP_BYTES = 256


def _build_rows(ell: torch.Tensor, h: torch.Tensor,
                n_total: int) -> SubTreeNodes:
    """The Cartesian-tree build of every row of a (P, F) batch at once
    (``repro.core.build.build_parallel`` on each row).  ``h``: the
    divergence rows with column 0 already set to the -1 wall."""
    p, f = ell.shape
    dev = ell.device
    n_levels = rmq.log2_ceil(f) + 2
    vals, args = rmq.sparse_table(h, n_levels, with_args=True)
    idx = torch.arange(f, dtype=torch.int64, device=dev).expand(p, f)

    # psv[i]: largest j < i with h[j] < h[i]  (exists: h[0] = -1 wall)
    psv = rmq.prev_less(vals, idx, h)

    # nsv[i]: smallest j > i with h[j] < h[i]; == f if none.  A PSV over
    # [wall] + reversed(h): extended index r <-> original f - r.
    wall = torch.full((p, 1), -1, dtype=torch.int32, device=dev)
    vals_rev, _ = rmq.sparse_table(torch.cat([wall, h.flip(-1)], dim=1),
                                   n_levels)
    nsv = f - rmq.prev_less(vals_rev, f - idx, h)
    del vals_rev

    # canonical representative: leftmost argmin of h in (psv[i], i]
    rep = rmq.range_argmin(vals, args, psv + 1, idx)
    rep[:, 0] = 0

    # parent event: the deeper of h[psv], h[nsv]; rep() of that event
    h_ext = torch.cat([h, wall], dim=1)  # h[F] = -1 wall
    psv0 = torch.clamp(psv, min=0)
    pl = torch.gather(h, 1, psv0)
    pr = torch.gather(h_ext, 1, torch.clamp(nsv, max=f))
    parent_event = torch.where(pl >= pr, psv0, torch.clamp(nsv, max=f - 1))
    parent_rep = torch.gather(rep, 1, parent_event)

    # internal node of canonical event j lives at id f + j (j >= 1); the
    # sub-tree root is the canonical event of the global min
    is_rep = rep == idx
    root_event = rmq.range_argmin(
        vals, args, torch.ones((p, 1), dtype=torch.int64, device=dev),
        torch.full((p, 1), f - 1, dtype=torch.int64, device=dev))
    del vals, args
    valid_int = is_rep & (idx >= 1)

    # one extra dump column (id 2f) takes every non-canonical event's
    # write, so no two real writes land on one id; it is sliced off
    cap = 2 * f
    dst = torch.where(valid_int, f + idx, cap)
    parent = torch.full((p, cap + 1), -1, dtype=torch.int32, device=dev)
    depth = torch.zeros((p, cap + 1), dtype=torch.int32, device=dev)
    witness = torch.full((p, cap + 1), -1, dtype=torch.int32, device=dev)
    int_parent = torch.where(idx == root_event, -1, f + parent_rep)
    ell_prev = torch.gather(ell, 1, torch.clamp(idx - 1, min=0))
    parent.scatter_(1, dst, int_parent.to(torch.int32))
    depth.scatter_(1, dst, h)
    witness.scatter_(1, dst, ell_prev.to(torch.int32))

    # leaves: leaf k's parent is the deeper of events k, k+1
    hk = h_ext[:, :f]       # event on the left of leaf k
    hk1 = h_ext[:, 1:]      # event on the right
    lev = torch.where(hk >= hk1, idx, torch.clamp(idx + 1, max=f - 1))
    parent[:, :f] = (f + torch.gather(rep, 1, lev)).to(torch.int32)
    depth[:, :f] = (n_total - ell).to(torch.int32)
    witness[:, :f] = ell.to(torch.int32)

    n_internal = valid_int.sum(dim=1)
    return SubTreeNodes(parent[:, :cap], depth[:, :cap], witness[:, :cap],
                        f + n_internal, f)


def build_parallel(ell, b_off, n_total: int) -> SubTreeNodes:
    """One sub-tree: suffix sub-tree == Cartesian tree of ``B_off``
    (``repro.core.build.build_parallel``).  Event ``i`` (1 <= i < F)
    carries depth ``h[i] = b_off[i]``; the internal node holding event i
    is represented by the leftmost event of its LCP interval with the
    minimal depth; parents follow from previous/next smaller values."""
    ell = torch.as_tensor(ell)
    b_off = torch.as_tensor(b_off, device=ell.device)
    f = ell.shape[0]
    if f == 1:
        e0 = int(ell[0])
        return SubTreeNodes(*(torch.tensor(v, dtype=torch.int32,
                                           device=ell.device)
                              for v in ([1, -1], [n_total - e0, 0],
                                        [e0, e0])), n_nodes=2, n_leaves=1)
    nodes = build_parallel_batch(ell[None], b_off[None], n_total)
    return SubTreeNodes(nodes.parent[0], nodes.depth[0], nodes.witness[0],
                        int(nodes.n_nodes[0]), f)


# ---------------------------------------------------------------------------
# Batched builder: every sub-tree of a bucket in one (P, F_pad) batch
# ---------------------------------------------------------------------------
# Rows are per-PREFIX (one sub-tree each), padded to a common width F_pad.
# Padding is depth-0: padded positions get ``b_off = 0`` and ``ell =
# n_total``.  Real divergence depths are >= 1 (every vertical-partition
# prefix has length >= 1), so all padded events collapse into exactly ONE
# artificial internal node at string depth 0 — the canonical event is the
# first padded position f — which adopts the real sub-tree root and every
# padded leaf (see repro.core.build for why extraction is a pure id remap).

PAD_MIN = 2


def pad_width(max_freq: int) -> int:
    """Row width for :func:`build_parallel_batch` given the largest freq."""
    return max_freq + PAD_MIN


# Modeled fixed cost (in padded Cartesian-tree cells) of dispatching one
# more build bucket — the auto-tuner stops splitting once the padded-cell
# saving of another bucket drops below this.
BUCKET_OVERHEAD_CELLS = 4096


def bucket_pad_widths(freqs, max_buckets: int | None = None
                      ) -> list[tuple[int, np.ndarray]]:
    """Group row frequencies into histogram-driven pad-width buckets,
    exactly as ``repro.core.build.bucket_pad_widths``: rows are classed by
    ``pad_width(freq)`` rounded up to a power of four; with
    ``max_buckets=None`` a small DP over class boundaries picks the bucket
    count minimizing ``padded cells + k * BUCKET_OVERHEAD_CELLS``; an
    integer ``max_buckets`` keeps the largest classes and lets smaller
    rows fall up into the narrowest kept one.  Returns ``[(width,
    row_indices), ...]`` widest bucket first."""
    freqs = np.asarray(freqs, np.int64)
    if freqs.size == 0:
        return []
    pow4 = 4 ** np.ceil(
        np.log2(np.maximum(freqs + PAD_MIN, 1)) / 2).astype(np.int64)
    classes = np.sort(np.unique(pow4))[::-1]

    if max_buckets is not None:
        kept = classes[: max(1, max_buckets)]
        out = []
        for i, cls in enumerate(kept):
            # last (narrowest) kept class absorbs every smaller dropped class
            take = (pow4 <= cls) if i == len(kept) - 1 else (pow4 == cls)
            idx = np.nonzero(take)[0]
            if idx.size:
                out.append((pad_width(int(freqs[idx].max())), idx))
        return out

    # auto-tune: DP over contiguous class spans (widest class first)
    m = len(classes)
    cls_idx = [np.nonzero(pow4 == cls)[0] for cls in classes]
    counts = np.array([len(ix) for ix in cls_idx], np.int64)
    widths = np.array([pad_width(int(freqs[ix].max())) for ix in cls_idx],
                      np.int64)
    csum = np.concatenate([[0], np.cumsum(counts)])

    def span_cells(a: int, b: int) -> int:
        # one bucket over classes a..b-1 pads every row to widths[a]
        return int(widths[a] * (csum[b] - csum[a]))

    inf = float("inf")
    best = [[inf] * (m + 1) for _ in range(m + 1)]
    cut = [[0] * (m + 1) for _ in range(m + 1)]
    best[0][0] = 0.0
    for k in range(1, m + 1):
        for j in range(k, m + 1):
            for a in range(k - 1, j):
                cand = best[k - 1][a] + span_cells(a, j)
                if cand < best[k][j]:
                    best[k][j] = cand
                    cut[k][j] = a
    k_best = min(range(1, m + 1),
                 key=lambda k: best[k][m] + k * BUCKET_OVERHEAD_CELLS)

    bounds = [m]
    j = m
    for k in range(k_best, 0, -1):
        j = cut[k][j]
        bounds.append(j)
    bounds.reverse()  # [0, ..., m]
    out = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        idx = np.concatenate([cls_idx[i] for i in range(a, b)])
        out.append((int(widths[a]), np.sort(idx)))
    return out


def rows_per_chunk(f_pad: int, byte_budget: int = NODE_BUILD_BYTES) -> int:
    """How many rows of width ``f_pad`` one chunk of the batched build
    holds under ``byte_budget`` (at least one)."""
    levels = rmq.log2_ceil(f_pad) + 3
    per_cell = 3 * levels * 4 + _CELL_TEMP_BYTES
    return max(1, byte_budget // (per_cell * f_pad))


def build_parallel_batch(ell_rows, boff_rows, n_total: int, *,
                         byte_budget: int = NODE_BUILD_BYTES) -> SubTreeNodes:
    """The Cartesian-tree build of every (P, F_pad) padded row
    (``repro.core.build.build_parallel_batch``), in row chunks of
    :func:`rows_per_chunk` rows.  Returns (P, 2 F_pad) node tensors on the
    rows' device and ``n_nodes`` as an int64[P] tensor."""
    ell_rows = torch.as_tensor(ell_rows)
    boff_rows = torch.as_tensor(boff_rows, device=ell_rows.device)
    p, f = ell_rows.shape
    chunk = rows_per_chunk(f, byte_budget)
    parts = []
    for r0 in range(0, p, chunk):
        ell = ell_rows[r0:r0 + chunk].to(torch.int64)
        h = boff_rows[r0:r0 + chunk].to(torch.int32).clone()
        h[:, 0] = -1  # sentinel left wall at 0
        parts.append(_build_rows(ell, h, n_total))
    if len(parts) == 1:
        return parts[0]
    return SubTreeNodes(*(torch.cat([getattr(x, name) for x in parts])
                          for name in ("parent", "depth", "witness",
                                       "n_nodes")), f)


# ---------------------------------------------------------------------------
# Word-key node build: divergence depths recomputed from the TEXT
# ---------------------------------------------------------------------------
# For adjacent leaves of one sub-tree the divergence depth IS the pairwise
# suffix LCP, which the compare currency of the text recomputes directly
# (``suffix_lcp_words`` on dense text, ``suffix_lcp_pairs`` on a byte
# string, the byte-key oracle under REPRO_WORD_COMPARE=byte).


def lcp_from_text(s_text, pos_a, pos_b, *, w0: int = 64, w_cap: int = 256,
                  max_rounds: int = 10_000) -> torch.Tensor:
    """Pairwise suffix LCP (in symbols) recomputed from the text, as an
    int64 tensor on the text's device (``repro.core.build.lcp_from_text``).

    ``pos_a``/``pos_b``: positions of DISTINCT suffixes.  Probes
    :func:`repro_torch.kernels.ops.suffix_lcp_pairs` windows and doubles
    the window up to ``w_cap`` while pairs saturate; saturated pairs
    advance by the window and probe again, so the work per pair is
    O(lcp).  The pending set, the sums and the positions stay on the
    device.  (The JAX package pads the pending set to a power of two to
    bound its jit shapes; the padded rows' results are discarded, so the
    port probes only the pending pairs.)
    """
    from repro_torch.kernels import ops as kops  # local: import cycle

    dev = s_text.device
    pos_a = torch.as_tensor(pos_a, device=dev).to(torch.int64)
    pos_b = torch.as_tensor(pos_b, device=dev).to(torch.int64)
    acc = torch.zeros(pos_a.shape[0], dtype=torch.int64, device=dev)
    pending = torch.arange(pos_a.shape[0], device=dev)
    w = max(4, (w0 + 3) // 4 * 4)
    w_top = max(4, (w_cap + 3) // 4 * 4)
    rounds = 0
    while pending.numel():
        if rounds >= max_rounds:
            raise RuntimeError(
                f"lcp_from_text failed to resolve {pending.numel()} pairs "
                f"after {rounds} rounds (equal positions in the input?)")
        a = (pos_a[pending] + acc[pending]).to(torch.int32)
        b = (pos_b[pending] + acc[pending]).to(torch.int32)
        lcp = kops.suffix_lcp_pairs(s_text, a, b, w)
        acc[pending] += lcp.to(torch.int64)
        pending = pending[lcp == w]  # saturated windows continue deeper
        w = min(w * 2, w_top)
        rounds += 1
    return acc


def boff_rows_from_text(s_text, ell_rows, n_total: int) -> torch.Tensor:
    """(P, F_pad) int32 divergence rows for :func:`build_parallel_batch`,
    recomputed from the text instead of gathered from stored ``b_off``.
    Padded cells carry ``ell = n_total``; any pair touching one keeps
    ``b_off = 0``, and column 0 is the builder's sentinel slot."""
    e = torch.as_tensor(ell_rows, device=s_text.device).to(torch.int64)
    p, f_pad = e.shape
    boff = torch.zeros((p, f_pad), dtype=torch.int32, device=e.device)
    if f_pad >= 2:
        a = e[:, :-1].reshape(-1)
        b = e[:, 1:].reshape(-1)
        idx = torch.nonzero((a < n_total) & (b < n_total)).flatten()
        lcp = torch.zeros(a.shape[0], dtype=torch.int64, device=e.device)
        if idx.numel():
            lcp[idx] = lcp_from_text(s_text, a[idx], b[idx])
        boff[:, 1:] = lcp.view(p, f_pad - 1).to(torch.int32)
    return boff


def build_parallel_batch_from_text(s_text, ell_rows, n_total: int
                                   ) -> SubTreeNodes:
    """The word-key bucketed builder: the batched Cartesian-tree build
    whose divergence depths come straight from the text."""
    boff_rows = boff_rows_from_text(s_text, ell_rows, n_total)
    return build_parallel_batch(ell_rows, boff_rows, n_total)


def unpad_nodes_row(parent_row: np.ndarray, depth_row: np.ndarray,
                    witness_row: np.ndarray, f: int) -> SubTreeNodes:
    """Extract the compact 2f-slot node set of one sub-tree from a padded
    builder row (host numpy).

    Row-space ids: leaves ``0..f-1`` (kept), internal ``F_pad + j`` for
    canonical events ``j`` in ``1..f-1`` (→ ``f + j``), and the artificial
    depth-0 root ``F_pad + f`` (→ ``f``, the slot event 0 never uses).
    """
    f_pad = len(parent_row) // 2
    cap = 2 * f

    def remap(v):
        v = np.asarray(v, np.int64)
        out = np.where(v == f_pad + f, f, np.where(v >= f_pad, v - f_pad + f, v))
        return out.astype(np.int32)

    parent = np.full(cap, -1, np.int32)
    depth = np.zeros(cap, np.int32)
    witness = np.full(cap, -1, np.int32)
    parent[:f] = remap(parent_row[:f])
    depth[:f] = depth_row[:f]
    witness[:f] = witness_row[:f]

    ev = np.arange(1, f + 1)            # candidate canonical events + root
    row_ids = f_pad + ev
    valid = witness_row[row_ids] >= 0   # written iff the event is canonical
    ev = ev[valid]
    lid = np.where(ev == f, f, f + ev)
    parent[lid] = remap(parent_row[f_pad + ev])
    depth[lid] = depth_row[f_pad + ev]
    witness[lid] = witness_row[f_pad + ev]
    return SubTreeNodes(parent, depth, witness, f + int(valid.sum()), f)


def unpad_nodes_rows(nodes: SubTreeNodes, freqs,
                     copies=None) -> list[SubTreeNodes]:
    """:func:`unpad_nodes_row` for every row of a batched build at once:
    the compact slots of all rows are gathered on the rows' device into one
    flat array per field and copied to the host once (half the bytes of
    the padded rows), then split into per-row views.  Given ``copies`` (a
    ``BuildReport``), the row counts sent and every array read back add
    to ``copies.bytes_to_device`` / ``copies.bytes_to_host``.

    Compact slot ``c`` of a row with ``f`` leaves reads row-space id ``c``
    (a leaf, c < f), ``F_pad + f`` (the depth-0 root, c == f) or
    ``F_pad + c - f`` (canonical event ``c - f``); an internal slot whose
    event is not canonical (witness < 0) keeps the empty node."""
    parent = torch.as_tensor(nodes.parent)
    dev = parent.device
    f_pad = parent.shape[1] // 2
    freqs = torch.as_tensor(np.asarray(freqs, np.int64), device=dev)
    sizes = 2 * freqs
    row = torch.repeat_interleave(torch.arange(freqs.shape[0], device=dev),
                                  sizes)
    c = torch.arange(row.shape[0], device=dev) - torch.repeat_interleave(
        torch.cumsum(sizes, 0) - sizes, sizes)
    f = freqs[row]
    src = torch.where(c < f, c, torch.where(c == f, f_pad + f,
                                            f_pad + c - f))
    flat = row * (2 * f_pad) + src
    p_v = parent.reshape(-1)[flat].to(torch.int64)
    d_v = torch.as_tensor(nodes.depth).reshape(-1)[flat]
    w_v = torch.as_tensor(nodes.witness).reshape(-1)[flat]
    empty = (c >= f) & (w_v < 0)
    p_v = torch.where(p_v == f_pad + f, f,
                      torch.where(p_v >= f_pad, p_v - f_pad + f, p_v))
    out = [torch.where(empty, -1, p_v).to(torch.int32),
           torch.where(empty, 0, d_v), torch.where(empty, -1, w_v)]
    n_int = torch.zeros(freqs.shape[0], dtype=torch.int64, device=dev)
    n_int.index_add_(0, row, (~empty & (c >= f)).to(torch.int64))
    host = [x.cpu().numpy() for x in (sizes, *out, freqs, n_int)]
    if copies is not None:
        copies.bytes_to_device += freqs.nbytes
        copies.bytes_to_host += sum(x.nbytes for x in host)
    sizes_h, *out_h, fs, n_int_h = host
    cuts = np.cumsum(sizes_h)[:-1]
    parent_h, depth_h, witness_h = (np.split(x, cuts) for x in out_h)
    return [SubTreeNodes(p_r, d_r, w_r, int(fr + ni), int(fr))
            for p_r, d_r, w_r, fr, ni in zip(parent_h, depth_h, witness_h,
                                             fs, n_int_h)]


# ---------------------------------------------------------------------------
# Canonicalization for testing: node set -> (l, r, depth) intervals
# ---------------------------------------------------------------------------

def nodes_to_intervals(nodes: SubTreeNodes):
    """Internal-node intervals (leftmost leaf, rightmost leaf + 1, depth),
    sorted.  Every leaf walks to the root, all leaves one level a pass
    (a pass per level of the deepest leaf), each node keeping the least
    and largest leaf that reached it."""
    nodes = nodes_to_host(nodes)
    parent = np.asarray(nodes.parent, np.int64)
    depth = nodes.depth
    f = nodes.n_leaves
    cap = len(parent)
    lo = np.full(cap, np.iinfo(np.int64).max)
    hi = np.full(cap, -1)
    leaf = np.arange(f)
    v = leaf.copy()
    for _ in range(cap + 1):
        if v.size == 0:
            break
        np.minimum.at(lo, v, leaf)
        np.maximum.at(hi, v, leaf)
        up = parent[v]
        walking = up != -1
        v, leaf = up[walking], leaf[walking]
    else:
        raise RuntimeError(f"parent cycle detected at leaf {int(leaf[0])}")
    used = np.nonzero((np.arange(cap) >= f) & (hi >= lo)
                      & ((hi > lo) | (f == 1)))[0]
    out = sorted(zip(lo[used].tolist(), (hi[used] + 1).tolist(),
                     np.asarray(depth)[used].tolist()))
    # A depth-0 (0, f) node is an artificial unary super-root iff another
    # node also spans all leaves (at the true minimum divergence depth).
    has_real_root = any(l == 0 and r == f and d > 0 for (l, r, d) in out)
    if has_real_root:
        out = [iv for iv in out if iv != (0, f, 0)]
    return out

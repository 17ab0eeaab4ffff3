"""The plain reference: suffix order, ERA's sub-tree tables and nodes.

Plain PyTorch on whatever device it is given, from the string alone.  It
imports nothing of the program and takes nothing the program made.  Every
quantity is an integer, so the comparison is exact.

* :func:`suffix_order` -- the suffix array by prefix doubling (a sort of
  ``(rank[i], rank[i + h])`` per round), keeping each round's ranks;
  ``depth_cap`` stops the doubling at that depth and breaks the remaining
  ties by position: the control, an order exact only to ``depth_cap``
  symbols.
* :func:`adjacent_lcp` -- the LCP of each suffix with the one before it
  in the order, by binary lifting over the kept ranks.
* :func:`partition` -- the sub-trees of ERA's vertical partitioning (paper
  section 4.1): each suffix belongs to the shortest prefix of it that at
  most ``f_max`` suffixes share; sub-trees in suffix order.
* :func:`routing` -- the dense routing table over the prefixes at depth
  ``k_route``.
* :func:`tree_nodes` -- each sub-tree's nodes in the compact layout
  :func:`flat_tree` documents.

The terminal is the largest code and occurs once, at the end, so two
distinct suffixes differ at or before it and past-the-end reads never
decide a comparison.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_ROUNDS = 4096  # pointer-jumping rounds before the reference gives up


def f_max_of(memory_bytes: int) -> int:
    """ERA's Eq. 1: 60 % of the budget to the sub-tree, 2 nodes of 16 B a
    leaf."""
    return max(2, int(0.6 * memory_bytes) // 32)


def suffix_order(s: torch.Tensor, depth_cap: int | None = None):
    """(order int64[n], levels) of the terminated code string ``s``.

    ``levels`` holds ``(h, rank_h)`` for h = 1, 2, 4, ...: ``rank_h[i] ==
    rank_h[j]`` exactly when the h symbols from i and from j are equal
    (int32 ranks from 1; 0 stands for past the end)."""
    n = s.numel()
    dev = s.device
    rank = s.to(torch.int64) + 1
    levels = [(1, rank.to(torch.int32))]
    h = 1
    while True:
        if depth_cap is not None and h >= depth_cap:
            pos = torch.arange(n, device=dev)
            return torch.argsort(rank * (n + 1) + pos), levels
        nxt = torch.zeros_like(rank)
        if h < n:
            nxt[: n - h] = rank[h:]
        key = rank * (n + 2) + nxt
        del nxt
        order = torch.argsort(key)
        ks = key[order]
        del key
        new = torch.ones(n, dtype=torch.int64, device=dev)
        new[1:] += torch.cumsum((ks[1:] != ks[:-1]).to(torch.int64), 0)
        del ks
        rank = torch.empty_like(new)
        rank[order] = new
        h *= 2
        levels.append((h, rank.to(torch.int32)))
        if int(new[-1]) == n:
            return order, levels
        del order, new


def adjacent_lcp(order: torch.Tensor, levels) -> torch.Tensor:
    """int64[n]: LCP of suffix ``order[r]`` with ``order[r - 1]`` (0 at
    r = 0), exact when the last level's ranks are all distinct, or capped
    near twice the last level's depth otherwise."""
    n = order.numel()
    a, b = order[:-1], order[1:]
    lcp = torch.zeros(n - 1, dtype=torch.int64, device=order.device)
    for h, r in reversed(levels):
        ia, ib = a + lcp, b + lcp
        ok = (ia < n) & (ib < n)
        eq = ok & (r[ia.clamp(max=n - 1)] == r[ib.clamp(max=n - 1)])
        lcp += eq.to(torch.int64) * h
    return torch.cat([lcp.new_zeros(1), lcp])


def partition(s: torch.Tensor, order: torch.Tensor, lcp: torch.Tensor,
              f_max: int) -> dict:
    """The sub-tree table: ``sub_off``, ``sub_freq``, ``sub_plen`` (int64)
    and ``sub_prefix`` (int32[T, max_plen], -1 past each prefix), plus
    ``depth`` (each rank's prefix length) and ``start`` (sub-tree starts)."""
    n = order.numel()
    dev = order.device
    depth = torch.zeros(n, dtype=torch.int64, device=dev)
    todo = torch.ones(n, dtype=torch.bool, device=dev)
    t = 0
    while bool(todo.any()):
        t += 1
        brk = lcp < t
        brk[0] = True
        run = torch.cumsum(brk.to(torch.int64), 0) - 1
        size = torch.bincount(run)[run]
        now = todo & (size <= f_max)
        depth[now] = t
        todo &= ~now
    start = lcp < depth
    start[0] = True
    off = torch.nonzero(start).flatten()
    freq = torch.diff(off, append=off.new_tensor([n]))
    plen = depth[off]
    max_plen = int(plen.max())
    j = torch.arange(max_plen, device=dev)
    pos = (order[off][:, None] + j[None, :]).clamp(max=n - 1)
    prefix = torch.where(j[None, :] < plen[:, None], s[pos].to(torch.int32),
                         torch.full_like(pos, -1, dtype=torch.int32))
    return {"sub_off": off, "sub_freq": freq, "sub_plen": plen,
            "sub_prefix": prefix, "depth": depth, "start": start}


def routing(base: int, sub_prefix: np.ndarray, sub_plen: np.ndarray,
            sub_off: np.ndarray, sub_freq: np.ndarray,
            route_cap: int = 1 << 18) -> dict:
    """``k_route``: the deepest k with ``base**(k + 1) <= route_cap`` and k
    below the longest prefix (at least 1).  Each sub-tree owns the
    depth-k code interval of its prefix, truncated or extended by every
    symbol; ``win_lo[c]`` is where the first sub-tree whose interval ends
    at or after code c starts (the total past the last), ``win_hi[c]``
    where the last sub-tree whose interval starts at or before c ends (0
    before the first)."""
    max_plen = int(sub_plen.max())
    k = 1
    while base ** (k + 1) <= route_cap and k < max_plen:
        k += 1
    cells = base**k
    kk = np.minimum(sub_plen, k)
    code = np.zeros(len(sub_plen), np.int64)
    for j in range(k):
        code = np.where(j < kk, code * base + np.maximum(sub_prefix[:, j], 0),
                        code)
    lo = code * base ** (k - kk)
    hi = lo + base ** (k - kk) - 1
    ends = sub_off + sub_freq
    c = np.arange(cells, dtype=np.int64)
    total = int(ends[-1])
    first = np.searchsorted(hi, c, side="left")
    win_lo = np.where(first < len(hi), sub_off[np.minimum(first, len(hi) - 1)],
                      total)
    last = np.searchsorted(lo, c, side="right") - 1
    win_hi = np.where(last >= 0, ends[np.maximum(last, 0)], 0)
    return {"k_route": k, "win_lo": win_lo, "win_hi": win_hi}


def _nearest_smaller(h: torch.Tensor, step: int,
                     active: torch.Tensor) -> torch.Tensor:
    """For each active i, the nearest j in direction ``step`` with ``h[j] <
    h[i]``, by pointer jumping; every active i has a smaller value (a wall)
    somewhere that way."""
    n = h.numel()
    ptr = (torch.arange(n, device=h.device) + step).clamp(0, n - 1)
    for _ in range(MAX_ROUNDS):
        need = active & (h[ptr] >= h)
        if not bool(need.any()):
            return ptr
        ptr = torch.where(need, ptr[ptr], ptr)
    raise RuntimeError("nearest-smaller pointers did not settle")


def tree_nodes(s: torch.Tensor, order: torch.Tensor, lcp: torch.Tensor,
               part: dict) -> dict:
    """Every sub-tree's nodes, concatenated in sub-tree order.

    A sub-tree of f leaves has 2f slots: leaves 0..f-1 (depth ``n -
    position``, witness the position); slot f a depth-0 root above the
    sub-tree; slot f + j the internal node whose leftmost shallowest
    divergence is between leaves j - 1 and j (depth that LCP, witness leaf
    j - 1's position); a slot no node takes has parent -1, depth 0,
    witness -1.  A node's parent is the node at the deeper of the nearest
    shallower divergences on its two sides (slot f where there is none).
    ``n_nodes``: f plus the nodes held.  ``b_off``, ``b_c1``, ``b_c2``:
    each leaf's LCP with the leaf before it and the two symbols after it
    (0 at a sub-tree's first leaf)."""
    n = order.numel()
    dev = order.device
    start = part["start"]
    off, freq = part["sub_off"], part["sub_freq"]
    seg = torch.cumsum(start.to(torch.int64), 0) - 1
    loc = torch.arange(n, device=dev) - off[seg]
    f = freq[seg]
    # divergence events: h[r] between ranks r-1 and r, a -1 wall at each
    # sub-tree's start and at index n, after the last sub-tree
    real = ~start
    ranks = torch.arange(n, device=dev)
    h = torch.where(start, torch.full_like(lcp, -1), lcp)
    h_ext = torch.cat([h, h.new_full((1,), -1)])
    act = torch.cat([real, real.new_zeros(1)])
    psv = torch.where(real, _nearest_smaller(h_ext, -1, act)[:n], -1)
    nsv = _nearest_smaller(h_ext, 1, act)[:n]
    # each internal node is one (left wall, depth) pair; its slot is the
    # leftmost event of the pair
    key = psv * (int(h.max()) + 2) + h
    _, inv = torch.unique(key, return_inverse=True)
    rep = torch.full((int(inv.max()) + 1,), n, dtype=torch.int64, device=dev)
    rep.scatter_reduce_(0, inv, ranks, reduce="amin")
    rep = rep[inv]
    canon = real & (rep == ranks)
    # a divergence at a sub-tree's end reads as 0 (the root's depth)
    at_end = (nsv >= n) | start[nsv.clamp(max=n - 1)]
    h_right = torch.where(at_end, torch.zeros_like(h), h_ext[nsv])
    h_left = h_ext[psv.clamp(min=0)]
    up = torch.where(h_left >= h_right, psv, nsv)
    up_root = torch.maximum(h_left, h_right) <= 0
    slot0 = 2 * off[seg]  # first slot of each rank's sub-tree
    parent = torch.full((2 * n,), -1, dtype=torch.int64, device=dev)
    depth = torch.zeros(2 * n, dtype=torch.int64, device=dev)
    witness = torch.full((2 * n,), -1, dtype=torch.int64, device=dev)
    node_of = lambda event: f + (rep[event.clamp(0, n - 1)]
                                 - off[seg])  # local slot of an event's node
    # internal nodes
    dst = (slot0 + f + loc)[canon]
    parent[dst] = torch.where(up_root, f, node_of(up))[canon]
    depth[dst] = h[canon]
    prev = order[(ranks - 1).clamp(min=0)]
    witness[dst] = prev[canon]
    # the depth-0 root of each sub-tree
    last = off + freq - 1
    parent[2 * off + freq] = -1
    depth[2 * off + freq] = 0
    witness[2 * off + freq] = order[last]
    # leaves: the deeper of the divergences on their two sides
    h_next = torch.where(loc + 1 >= f, torch.zeros_like(h),
                         h_ext[ranks + 1])
    right = h_next > h
    leaf_parent = torch.where(
        right & (loc + 1 >= f), f,
        torch.where(right, node_of(ranks + 1), node_of(ranks)))
    parent[slot0 + loc] = leaf_parent
    depth[slot0 + loc] = n - order
    witness[slot0 + loc] = order
    n_int = torch.zeros_like(off)
    n_int.index_add_(0, seg, canon.to(torch.int64))
    # divergence symbols after the shared prefix, with the leaf before
    sym = lambda p: s[(p + lcp).clamp(max=n - 1)].to(torch.int64)
    zero = torch.zeros_like(lcp)
    return {"b_off": torch.where(real, lcp, zero),
            "b_c1": torch.where(real, sym(prev), zero),
            "b_c2": torch.where(real, sym(order), zero),
            "parent": parent, "depth": depth, "witness": witness,
            "n_nodes": freq + 1 + n_int, "inner": real}


def index_tables(s: torch.Tensor, base: int, f_max: int, *,
                 depth_cap: int | None = None, tree: bool = False) -> dict:
    """Everything a cell compares, for one string: the suffix order
    ``ell``, the sub-tree and routing tables, and with ``tree`` the nodes.
    ``depth_cap`` computes the control instead."""
    order, levels = suffix_order(s, depth_cap)
    lcp = adjacent_lcp(order, levels)
    del levels
    part = partition(s, order, lcp, f_max)
    host = lambda t: t.cpu().numpy()
    out = {"ell": order,
           "sub_off": part["sub_off"], "sub_freq": part["sub_freq"],
           "sub_plen": part["sub_plen"], "sub_prefix": part["sub_prefix"]}
    out.update(routing(base, host(part["sub_prefix"]), host(part["sub_plen"]),
                       host(part["sub_off"]), host(part["sub_freq"])))
    if tree:
        out.update(tree_nodes(s, order, lcp, part))
    return out

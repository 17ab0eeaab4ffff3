"""ERA-str: Algorithms ComputeSuffixSubTree + BranchEdge (paper §4.2.1) —
the port's own copy of ``repro.core.branch_edge`` (numpy only).

The paper's FIRST horizontal-partitioning variant: breadth-first edge
refinement driven by Proposition 1, with the level-amortized scan
optimization (one pass over S per level, shared by all active edges) but
WITHOUT the (L, B) memory-access optimization of §4.2.2.  It is an
independent oracle for the elastic-range pipeline (same trees out); no
build path calls it.

WaveFront-style construction (the paper's main competitor) is this same
level-by-level discipline with a fixed range of 1 symbol per scan;
:func:`wavefront_build` models it.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class EdgeNode:
    """Pointer-style node (deliberately the paper's §4.2.1 representation)."""

    depth: int                 # symbols from root to the END of this edge
    occs: np.ndarray           # occurrence positions of pathlabel(e)
    children: dict             # first symbol -> EdgeNode
    parent_depth: int          # depth at the START of this edge
    leaf_pos: int = -1


@dataclasses.dataclass
class StrStats:
    scans: int = 0
    levels: int = 0
    nodes: int = 0


def compute_suffix_subtree(s: np.ndarray, positions: np.ndarray, p_len: int,
                           stats: StrStats | None = None,
                           range_sym: int = 16) -> EdgeNode:
    """Build T_p by level-by-level BranchEdge (occurrence-list refinement).

    ``range_sym`` models optimization 2 of §4.2.1: each scan of S fetches a
    range of symbols, so one pass serves ``range_sym`` refinement levels.
    """
    n = len(s)
    stats = stats if stats is not None else StrStats()
    root = EdgeNode(depth=p_len, occs=np.asarray(positions, np.int64),
                    children={}, parent_depth=0)
    active = [root]
    while active:
        stats.levels += 1
        if (stats.levels - 1) % max(1, range_sym) == 0:
            stats.scans += 1  # one amortized pass serves range_sym levels
        nxt: list[EdgeNode] = []
        for e in active:
            if len(e.occs) == 1:
                e.leaf_pos = int(e.occs[0])
                continue
            idx = e.occs + e.depth
            syms = np.where(idx < n, s[np.minimum(idx, n - 1)], -1)
            uniq = np.unique(syms)
            if len(uniq) == 1:
                e.depth += 1  # Prop. 1 case 2: extend the label
                nxt.append(e)
                continue
            for c in uniq:  # Prop. 1 case 3: branch
                occ_c = e.occs[syms == c]
                child = EdgeNode(depth=e.depth + 1, occs=occ_c, children={},
                                 parent_depth=e.depth)
                e.children[int(c)] = child
                stats.nodes += 1
                nxt.append(child)
        active = nxt
    return root


def tree_to_intervals(root: EdgeNode, s: np.ndarray):
    """Canonical (l, r, depth) intervals — comparable with
    :func:`repro_torch.core.build.nodes_to_intervals`.

    Leaves are ordered by DFS with children visited in symbol order, which
    equals lexicographic order of the suffixes.
    """
    out = []
    counter = [0]

    def walk(e: EdgeNode):
        if e.leaf_pos >= 0 and not e.children:
            i = counter[0]
            counter[0] += 1
            return i, i + 1
        lo, hi = None, None
        for c in sorted(e.children):
            l, r = walk(e.children[c])
            lo = l if lo is None else lo
            hi = r
        if hi - lo >= 2:
            out.append((lo, hi, e.depth))
        return lo, hi

    walk(root)
    return sorted(out)


def wavefront_build(s: np.ndarray, positions: np.ndarray, p_len: int,
                    stats: StrStats | None = None) -> EdgeNode:
    """WaveFront-discipline baseline: same tree, but one SYMBOL per scan
    (range=1; no elastic growth) and per-level full passes — the I/O and
    iteration profile the paper beats (Figs. 9b/10)."""
    return compute_suffix_subtree(s, positions, p_len, stats, range_sym=1)

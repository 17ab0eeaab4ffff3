"""The plain reference against brute force at n = 2^12: the suffix order
by sorting the suffixes themselves, the LCPs by comparing them, the
partition by counting prefixes, the tree's nodes as LCP intervals."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from erabench.data import strings
from erabench.reference import suffix_order as R

CASES = [(4, 0.45, 4096, 2**33 + 1), (20, 0.15, 4096, 2**33 + 2),
         (4, 0.9, 3000, 2000)]


def string(sigma, frac, n=1 << 12, seed=9):
    return strings.synthetic_string(n, sigma, seed, 0,
                                    repeat_fraction=frac, repeat_len=64)


def brute_order(s: np.ndarray) -> np.ndarray:
    b = s.tobytes()
    return np.array(sorted(range(len(b)), key=lambda i: b[i:]))


def brute_lcp(s, i, j):
    k = 0
    while i + k < len(s) and j + k < len(s) and s[i + k] == s[j + k]:
        k += 1
    return k


@pytest.mark.parametrize("sigma,frac,memory,seed", CASES)
def test_reference_against_brute_force(sigma, frac, memory, seed):
    s = string(sigma, frac, seed=seed)
    n = len(s)
    f_max = R.f_max_of(memory)
    ref = R.index_tables(torch.from_numpy(s), sigma + 1, f_max, tree=True)
    order = brute_order(s)
    assert np.array_equal(ref["ell"].numpy(), order)
    lcp = np.array([0] + [brute_lcp(s, order[r - 1], order[r])
                          for r in range(1, n)])
    inner = ref["inner"].numpy()
    assert np.array_equal(ref["b_off"].numpy(), np.where(inner, lcp, 0))
    # partition: each suffix's prefix is its shortest one shared by at
    # most f_max suffixes
    counts: dict = {}
    for i in range(n):
        for t in range(1, min(40, n - i) + 1):
            counts[bytes(s[i:i + t])] = counts.get(bytes(s[i:i + t]), 0) + 1
    off = ref["sub_off"].numpy()
    plen = ref["sub_plen"].numpy()
    seen = set()
    for t_i, (o, f, p) in enumerate(zip(off, ref["sub_freq"].numpy(), plen)):
        i = order[o]
        pre = bytes(s[i:i + p])
        assert counts[pre] == f <= f_max
        assert p == 1 or counts[bytes(s[i:i + p - 1])] > f_max
        assert list(ref["sub_prefix"].numpy()[t_i, :p]) == list(pre)
        seen.add(pre)
    assert ref["sub_freq"].sum() == n and len(seen) == len(off)
    # nodes: every sub-tree's internal nodes are its LCP intervals
    parent = ref["parent"].numpy()
    depth = ref["depth"].numpy()
    for o, f in zip(off, ref["sub_freq"].numpy()):
        slots = slice(2 * o, 2 * o + 2 * f)
        got = intervals(parent[slots], depth[slots], f)
        want = {(0, f, 0)} | lcp_intervals(lcp[o:o + f])
        assert got == want


def intervals(parent, depth, f):
    lo, hi = {}, {}
    for leaf in range(f):
        v = parent[leaf]
        while v != -1:
            lo[v] = min(lo.get(v, f), leaf)
            hi[v] = max(hi.get(v, -1), leaf)
            v = parent[v]
    return {(lo[v], hi[v] + 1, int(depth[v])) for v in lo}


def lcp_intervals(h):
    """(l, r, depth) of every LCP interval of one sub-tree's leaves (h[0]
    unused), by the classic stack walk."""
    out = set()
    stack = []  # (depth, left)
    for i in range(1, len(h) + 1):
        d = h[i] if i < len(h) else 0
        left = i - 1
        while stack and stack[-1][0] > d:
            dd, left = stack.pop()
            out.add((left, i, int(dd)))
        if not stack or stack[-1][0] < d:
            stack.append((d, left))
    return {iv for iv in out if iv[2] > 0}


def test_control_breaks_the_order():
    s = string(4, 0.45)
    exact = R.suffix_order(torch.from_numpy(s))[0]
    capped = R.suffix_order(torch.from_numpy(s), depth_cap=16)[0]
    assert not torch.equal(exact, capped)

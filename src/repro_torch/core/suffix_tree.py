"""Assembled suffix-tree index: trie-on-top + per-prefix sub-trees.
PyTorch port of ``repro.core.suffix_tree``.

The index (paper §4, Figure 3) is a small top trie over the vertical
partition prefixes plus one sub-tree per prefix, each in
structure-of-arrays form (:class:`repro_torch.core.build.SubTreeNodes`)
beside its leaf array ``L`` — the suffix array restricted to the prefix.
The sub-trees live on the host (numpy), as in the JAX package; the index
carries the device it was built on, so its flattened form
(:meth:`SuffixTreeIndex.to_device`) and its analytics engine
(:meth:`SuffixTreeIndex.analytics`) stay there.

Three query paths, slowest to fastest:

* ``find``       — per-pattern numpy binary search (the reference oracle);
* ``find_walk``  — per-pattern tree walk (validates the built topology);
* ``find_batch`` — the device-resident batched engine
  (:class:`repro_torch.core.query.DeviceIndex`).

Archives keep the JAX package's npz layout, so indexes load both ways.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.alphabet import Alphabet
from repro_torch.core.build import SubTreeNodes, nodes_to_host


@dataclasses.dataclass
class SubTree:
    prefix: tuple[int, ...]
    ell: np.ndarray          # int32[f] leaf positions, lexicographic order
    b_off: np.ndarray        # int32[f]
    b_c1: np.ndarray
    b_c2: np.ndarray
    nodes: SubTreeNodes | None = None  # filled by BuildSubTree

    @property
    def freq(self) -> int:
        return len(self.ell)


def _cmp_suffix(s: np.ndarray, pos: int, pattern: np.ndarray) -> int:
    """-1/0/+1: compare suffix at ``pos`` against ``pattern`` (prefix match = 0)."""
    m = len(pattern)
    chunk = s[pos : pos + m]
    if len(chunk) < m:
        pad = np.full(m - len(chunk), np.iinfo(np.int32).max, dtype=np.int64)
        chunk = np.concatenate([chunk.astype(np.int64), pad])
    diff = np.nonzero(chunk.astype(np.int64) - pattern.astype(np.int64))[0]
    if len(diff) == 0:
        return 0
    d = diff[0]
    return -1 if chunk[d] < pattern[d] else 1


@dataclasses.dataclass
class SuffixTreeIndex:
    s: np.ndarray            # the indexed string (codes incl. terminal)
    alphabet: Alphabet
    subtrees: dict[tuple[int, ...], SubTree]
    device: object = "cuda"  # where to_device / analytics place the engine
    _device: object = dataclasses.field(default=None, repr=False, compare=False)
    _analytics: object = dataclasses.field(default=None, repr=False, compare=False)

    # ---- top trie ---------------------------------------------------------

    def route(self, pattern: np.ndarray) -> list[tuple[int, ...]]:
        """Prefixes whose sub-tree may contain occurrences of ``pattern``."""
        m = len(pattern)
        out = []
        for p in self.subtrees:
            k = min(len(p), m)
            if tuple(pattern[:k]) == p[:k]:
                out.append(p)
        return out

    # ---- queries ----------------------------------------------------------

    def find(self, pattern: np.ndarray) -> np.ndarray:
        """All occurrence positions of ``pattern`` in S (suffix-array search
        within the routed sub-trees; O(|route| * log f * |P|))."""
        hits = []
        m = len(pattern)
        for p in self.route(pattern):
            st = self.subtrees[p]
            if len(p) >= m:
                hits.append(st.ell)  # whole sub-tree matches
                continue
            lo, hi = 0, st.freq  # lower bound: first suffix >= pattern
            while lo < hi:
                mid = (lo + hi) // 2
                if _cmp_suffix(self.s, int(st.ell[mid]), pattern) < 0:
                    lo = mid + 1
                else:
                    hi = mid
            first = lo
            lo, hi = first, st.freq
            while lo < hi:
                mid = (lo + hi) // 2
                if _cmp_suffix(self.s, int(st.ell[mid]), pattern) == 0:
                    lo = mid + 1
                else:
                    hi = mid
            hits.append(st.ell[first:lo])
        if not hits:
            return np.empty(0, dtype=np.int64)
        return np.sort(np.concatenate(hits).astype(np.int64))

    def find_walk(self, pattern: np.ndarray) -> np.ndarray:
        """Tree-walk search (the paper's O(|P|) descent) — validates the
        built topology; needs ``nodes`` on the routed sub-trees."""
        hits = []
        m = len(pattern)
        for p in self.route(pattern):
            st = self.subtrees[p]
            if len(p) >= m:
                hits.append(st.ell)
                continue
            if st.nodes is None:
                raise ValueError("sub-tree not built; call with build_impl set")
            node = self._descend(st, pattern)
            if node is not None:
                hits.append(st.ell[node[0] : node[1]])
        if not hits:
            return np.empty(0, dtype=np.int64)
        return np.sort(np.concatenate(hits).astype(np.int64))

    def _descend(self, st: SubTree, pattern: np.ndarray):
        """Walk the sub-tree matching ``pattern``; return (lo, hi) leaf span."""
        # one host conversion, written back so repeated queries never copy
        nodes = st.nodes = nodes_to_host(st.nodes)
        parent = nodes.parent
        depth = nodes.depth
        f = nodes.n_leaves
        # children lists + leaf spans computed lazily and cached on the obj
        if not hasattr(st, "_children"):
            cap = len(parent)
            wit = nodes.witness
            kids: list[list[int]] = [[] for _ in range(cap)]
            root = -1
            for v in range(cap):
                pv = int(parent[v])
                if pv >= 0:
                    kids[pv].append(v)
                elif v >= f and wit[v] >= 0:
                    root = v
            lo = np.full(cap, 10**9)
            hi = np.full(cap, -1)
            for leaf in range(f):
                v = leaf
                while v != -1:
                    lo[v] = min(lo[v], leaf)
                    hi[v] = max(hi[v], leaf)
                    v = int(parent[v])
            st._children = kids
            st._span = (lo, hi)
            st._root = root
        kids = st._children
        lo, hi = st._span
        witness = nodes.witness

        v = st._root
        if v < 0:
            return None
        matched = 0
        m = len(pattern)
        while matched < m:
            nxt = None
            for c in kids[v]:
                # edge label = S[witness[c]+depth[v] : witness[c]+depth[c]]
                e0 = int(witness[c]) + int(depth[v])
                if self.s[e0] == pattern[matched]:
                    nxt = c
                    break
            if nxt is None:
                return None
            elen = int(depth[nxt]) - int(depth[v])
            take = min(elen, m - matched)
            e0 = int(witness[nxt]) + int(depth[v])
            if not np.array_equal(self.s[e0:e0 + take],
                                  pattern[matched : matched + take]):
                return None
            matched += take
            v = nxt
        return int(lo[v]), int(hi[v]) + 1

    # ---- batched device fast path -----------------------------------------

    def to_device(self, **kwargs):
        """Flatten into a :class:`repro_torch.core.query.DeviceIndex` on
        this index's device (kwargs: ``route_cap``, ``max_pattern_len``,
        ``packing``)."""
        from repro_torch.core.query import DeviceIndex  # local: import cycle

        return DeviceIndex.from_index(self, **kwargs)

    def find_batch(self, patterns) -> list[np.ndarray]:
        """Batched ``find`` through the flattened device form (built on
        first use and cached): sorted int64 occurrence positions."""
        if self._device is None:
            self._device = self.to_device()
        return self._device.find_batch(patterns)

    def analytics(self, **kwargs):
        """The LCP + analytics engine
        (:class:`repro_torch.core.analytics.AnalyticsEngine`) over this
        index.  Without flattening kwargs the engine AND its flattened
        device form are shared with ``find_batch`` (built once, cached)."""
        from repro_torch.core.analytics import AnalyticsEngine  # import cycle

        if kwargs:
            return AnalyticsEngine.from_index(self, **kwargs)
        if self._analytics is None:
            if self._device is None:
                self._device = self.to_device()
            self._analytics = AnalyticsEngine.from_index(self, dev=self._device)
        return self._analytics

    # ---- stats / io -------------------------------------------------------

    @property
    def n_leaves(self) -> int:
        return sum(st.freq for st in self.subtrees.values())

    @property
    def n_internal(self) -> int:
        tot = 0
        for st in self.subtrees.values():
            if st.nodes is not None:
                tot += int(st.nodes.n_nodes) - int(st.nodes.n_leaves)
        return tot

    def save(self, path: str) -> None:
        """The JAX package's layout: ``s``, ``alphabet`` and per sub-tree
        ``p{i}_prefix|ell|boff|bc1|bc2`` plus the node arrays when built."""
        blobs = {"s": self.s, "alphabet": np.frombuffer(
            self.alphabet.name.encode(), dtype=np.uint8)}
        for i, (p, st) in enumerate(sorted(self.subtrees.items())):
            blobs[f"p{i}_prefix"] = np.array(p, dtype=np.int32)
            blobs[f"p{i}_ell"] = np.asarray(st.ell)
            blobs[f"p{i}_boff"] = np.asarray(st.b_off)
            blobs[f"p{i}_bc1"] = np.asarray(st.b_c1)
            blobs[f"p{i}_bc2"] = np.asarray(st.b_c2)
            if st.nodes is not None:
                nodes = nodes_to_host(st.nodes)
                blobs[f"p{i}_nparent"] = nodes.parent
                blobs[f"p{i}_ndepth"] = nodes.depth
                blobs[f"p{i}_nwitness"] = nodes.witness
                blobs[f"p{i}_ncounts"] = np.array(
                    [nodes.n_nodes, nodes.n_leaves], np.int64)
        np.savez_compressed(path, **blobs)

    @classmethod
    def load(cls, path: str, alphabet: Alphabet,
             device="cuda") -> "SuffixTreeIndex":
        """Restore an archive written by :meth:`save` or by the JAX
        package's ``SuffixTreeIndex.save``."""
        subtrees = {}
        with np.load(path) as data:
            i = 0
            while f"p{i}_prefix" in data:
                p = tuple(int(x) for x in data[f"p{i}_prefix"])
                nodes = None
                if f"p{i}_nparent" in data:
                    counts = data[f"p{i}_ncounts"]
                    nodes = SubTreeNodes(
                        parent=data[f"p{i}_nparent"],
                        depth=data[f"p{i}_ndepth"],
                        witness=data[f"p{i}_nwitness"],
                        n_nodes=int(counts[0]),
                        n_leaves=int(counts[1]),
                    )
                subtrees[p] = SubTree(
                    prefix=p,
                    ell=data[f"p{i}_ell"],
                    b_off=data[f"p{i}_boff"],
                    b_c1=data[f"p{i}_bc1"],
                    b_c2=data[f"p{i}_bc2"],
                    nodes=nodes,
                )
                i += 1
            s = data["s"]
        return cls(s=s, alphabet=alphabet, subtrees=subtrees, device=device)

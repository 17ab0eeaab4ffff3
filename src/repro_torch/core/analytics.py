"""Device-resident LCP + analytics engine over the flattened ERA index.
PyTorch port of ``repro.core.analytics``.

The flattened index (:class:`DeviceIndex`, whose concatenated leaf array
IS the suffix array of S) becomes the classic SA + LCP analytics stack on
the index's device:

* **Global LCP array** — ``lcp[i] = LCP(suffix ell[i-1], suffix ell[i])``.
  Intra-subtree entries are the ``b_off`` divergence depths SubTreePrepare
  already computed; the T-1 cross-subtree boundary entries are strictly
  shorter than the shorter prefix (the prefixes are prefix-free), so one
  bounded-width pass of :func:`repro_torch.kernels.ops.suffix_lcp_pairs`
  fills them all (``suffix_lcp_words`` on dense text, ``suffix_lcp_pairs``
  on byte text, ``range_gather_packed`` + ``lcp_pairs`` under
  ``REPRO_WORD_COMPARE=byte``).
* **Sparse-table RMQ** (:mod:`repro_torch.core.rmq`), stacked once as an
  ``(L + 1, n)`` tensor — O(1) ``LCP(ell[i], ell[j]) = min(lcp[i+1..j])``
  and O(log n) maximal-interval expansion.

Four batched workloads ride on top, each equal to the JAX package's:
matching statistics (one lower-bound search per query position, all of
them in one search-kernel launch, then the two neighbours' gathers and
LCPs), top-k maximal repeats, the distinct-substring count, and the
k-mer spectrum.
``jax.lax.top_k`` returns equal values lowest index first; the port takes
the first k of a stable descending sort, which keeps that order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import packing, rmq
from repro_torch.core.query import DeviceIndex, npz_path
from repro_torch.kernels import ops as kops

_MS_BATCH_PAD = 64  # query positions round up to this (as in JAX)


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries, equal values lowest
    index first — the order ``jax.lax.top_k`` gives."""
    order = torch.sort(x, descending=True, stable=True).indices[:k]
    return x[order], order


def _matching_stats(s_text, ell, win_lo, win_hi, pows, q_ext: torch.Tensor,
                    n_q: int, *, k_route: int, n_iter: int, w: int,
                    word: bool) -> torch.Tensor:
    """Matching statistics of query positions 0..B-1 against the suffix
    array (``repro.core.analytics._matching_stats``).

    ``q_ext``: (B + w,) int32 query codes, terminal-padded past ``n_q``.
    Each position's window ``q[i:i+w]`` is routed and lower-bounded like a
    ``find_batch`` pattern (one search-kernel launch, ``bounds=1``:
    ``search_bounds_packed`` for byte keys on dense text); the
    max-LCP suffix is one of the two lexicographic neighbours of the
    insertion point.  ``word`` (dense text, terminal-free query) compares
    dense words with the window's first terminal as its limit; otherwise
    byte keys.  Returns int32 (2, B): (ms, witness).
    """
    dev = ell.device
    b = q_ext.shape[0] - w
    total = ell.shape[0]
    idx = torch.arange(b, dtype=torch.int64, device=dev)
    windows = q_ext[idx[:, None] + torch.arange(w, device=dev)[None, :]]
    # routing: the window is always k_route symbols deep (terminal-padded),
    # so its depth-k_route code owns exactly one cell
    c = torch.sum(windows[:, :k_route] * pows[None, :], dim=1)
    lo = win_lo[c]
    hi = torch.maximum(win_hi[c], lo)
    if word:
        bits = s_text.bits
        pat_words = packing.pack_pattern_dense(windows, bits, s_text.terminal)
        mask_words = packing.pack_dense(
            torch.full((1, w), (1 << bits) - 1, dtype=torch.int32,
                       device=dev), bits).expand_as(pat_words).contiguous()
        # the window holds real query symbols then terminal padding: its
        # comparison limit is the first terminal (== n_q - i, clipped)
        lim_p = torch.clamp(n_q - idx, 0, w).to(torch.int32)
        w_arr = torch.full((b,), w, dtype=torch.int32, device=dev)
        gather = kops.gather_words
    else:
        pat_words = packing.pack_words(windows)
        mask_words = torch.full_like(pat_words, -1)  # full-width comparison
        w_arr = lim_p = None
        gather = kops.range_gather
    pos = kops.search_bounds(s_text, ell, pat_words, mask_words, w_arr, lim_p,
                             lo, hi, n_iter=n_iter, bounds=1, word=word)[0]

    # the suffix maximizing LCP with the window is a lex neighbour of the
    # insertion point; compare both neighbours' reads with the window
    left_row = torch.clamp(pos - 1, 0, total - 1)
    right_row = torch.clamp(pos, 0, total - 1)
    lw = gather(s_text, ell[left_row], w)
    rw = gather(s_text, ell[right_row], w)
    if word:
        def window_lcp(sw, la):
            # min(first-diff, limits) — except when suffix and window hit
            # their terminals at the SAME index with no earlier real
            # difference: the byte rows then match through the equal
            # terminal padding, so the byte LCP is exactly w
            p = packing.lcp_words(sw, pat_words, bits)
            capped = torch.clamp(torch.minimum(torch.minimum(p, la), lim_p),
                                 max=w)
            return torch.where((la == lim_p) & (p >= la), w, capped)

        raw_l = window_lcp(lw, packing.word_limit(s_text.n_real,
                                                  ell[left_row], w))
        raw_r = window_lcp(rw, packing.word_limit(s_text.n_real,
                                                  ell[right_row], w))
    else:
        raw_l = kops.lcp_pairs(lw, pat_words, w)[0]
        raw_r = kops.lcp_pairs(rw, pat_words, w)[0]
    lcp_l = torch.where(pos > 0, raw_l, 0)
    lcp_r = torch.where(pos < total, raw_r, 0)
    best = torch.maximum(lcp_l, lcp_r)
    # window symbols past the query end are terminal padding: clipping to
    # the remaining query length makes the padded computation exact
    ms = torch.clamp(torch.minimum(best, n_q - idx), min=0)
    wit_row = torch.where(lcp_l >= lcp_r, left_row, right_row)
    witness = torch.where(ms > 0, ell[wit_row], -1)
    return torch.stack([ms.to(torch.int32), witness.to(torch.int32)])


@dataclasses.dataclass(frozen=True)
class AnalyticsEngine:
    """LCP array + RMQ + batched analytics over a :class:`DeviceIndex`."""

    dev: DeviceIndex
    lcp: torch.Tensor                   # int32[total] on the device; lcp[0] == 0
    lcp_host: np.ndarray
    vals: torch.Tensor                  # (L + 1, total) forward range-min table
    vals_rev: torch.Tensor              # (L + 1, total + 1) over [-1] + lcp[::-1]

    @property
    def total(self) -> int:
        return int(self.lcp_host.shape[0])

    # ---- construction -----------------------------------------------------

    @classmethod
    def from_index(cls, index, dev: DeviceIndex | None = None,
                   **device_kwargs) -> "AnalyticsEngine":
        """Build from a :class:`SuffixTreeIndex`: intra-subtree LCPs from
        the stored ``b_off`` depths, the cross-subtree boundaries from one
        suffix-LCP kernel pass on the index's device."""
        if dev is None:
            dev = DeviceIndex.from_index(index, **device_kwargs)
        prefixes = sorted(index.subtrees)
        parts = []
        for p in prefixes:
            b = np.asarray(index.subtrees[p].b_off, np.int32).copy()
            if len(b):
                b[0] = 0
            parts.append(b)
        lcp = np.concatenate(parts).astype(np.int32)
        if len(prefixes) > 1:
            bnd = dev.sub_off[1:].cpu().numpy().astype(np.int64)
            ell = dev.ell_host
            # prefix-freeness bounds every boundary LCP below the shorter
            # prefix length; one fixed-width kernel pass covers them all
            max_plen = max(len(p) for p in prefixes)
            w = -(-(max_plen + 1) // 4) * 4
            if w <= dev.max_pattern_len:  # the served padding covers w
                s_pad = dev.s_text
            else:  # a byte string padded for w (as the JAX package does)
                s_pad = torch.from_numpy(index.alphabet.pad_string(
                    np.asarray(index.s), extra=w + 8)).to(dev.device)
            take = lambda r: torch.from_numpy(
                np.ascontiguousarray(ell[r])).to(dev.device)
            cross = kops.suffix_lcp_pairs(s_pad, take(bnd - 1), take(bnd), w)
            lcp[bnd] = cross.cpu().numpy()
        return cls.from_device(dev, lcp)

    @classmethod
    def from_device(cls, dev: DeviceIndex, lcp) -> "AnalyticsEngine":
        lcp_host = (lcp.cpu().numpy() if isinstance(lcp, torch.Tensor)
                    else np.asarray(lcp)).astype(np.int32)
        total = int(lcp_host.shape[0])
        if total != dev.n_leaves:
            raise ValueError(f"lcp length {total} != n_leaves {dev.n_leaves}")
        h = torch.from_numpy(lcp_host).to(dev.device)
        n_levels = rmq.log2_ceil(max(total, 2)) + 2
        vals, _ = rmq.sparse_table(h, n_levels)
        wall = torch.full((1,), -1, dtype=torch.int32, device=dev.device)
        vals_rev, _ = rmq.sparse_table(torch.cat([wall, h.flip(0)]), n_levels)
        return cls(dev=dev, lcp=h, lcp_host=lcp_host, vals=vals,
                   vals_rev=vals_rev)

    # ---- persistence ------------------------------------------------------

    def save(self, path: str) -> None:
        """One npz holding the flattened index AND the LCP array (the JAX
        package's layout), so ``analytics_serve`` restarts skip both build
        and flatten."""
        blobs = self.dev.to_blobs()
        blobs["lcp"] = self.lcp_host
        np.savez_compressed(npz_path(path), **blobs)

    @classmethod
    def load(cls, path: str, device="cuda") -> "AnalyticsEngine":
        with np.load(npz_path(path)) as data:
            if "lcp" not in data:
                raise ValueError(
                    f"{path} has no 'lcp' array — it is a DeviceIndex "
                    f"(query_serve) cache, not an analytics cache; rebuild "
                    f"with AnalyticsEngine.save")
            dev = DeviceIndex.from_blobs(data, device=device)
            lcp = np.asarray(data["lcp"])
        return cls.from_device(dev, lcp)

    # ---- LCP-interval queries --------------------------------------------

    def _rows(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.int64,
                               device=self.dev.device)

    def lcp_rows(self, i, j) -> np.ndarray:
        """Batched LCP of the suffixes at SA rows ``i`` and ``j`` (any
        order; equal rows return the full suffix length)."""
        i, j = self._rows(i), self._rows(j)
        total = self.total
        lo = torch.minimum(i, j)
        hi = torch.maximum(i, j)
        pair = rmq.range_min(self.vals, torch.clamp(lo + 1, max=total - 1),
                             hi)
        out = torch.where(lo == hi, total - self.dev.ell[lo], pair)
        return out.to(torch.int32).cpu().numpy()

    # ---- matching statistics ---------------------------------------------

    def matching_stats(self, q, *, window: int | None = None):
        """Per-position longest match of ``q`` against the indexed string.

        Returns ``(ms, witness)``: for each i, ``ms[i]`` is the length of
        the longest prefix of ``q[i:]`` occurring somewhere in S and
        ``witness[i]`` one position where it occurs (-1 when ms == 0).
        Lengths are capped at ``window`` (default: the index's
        ``max_pattern_len``, the same cap ``find_batch`` has).
        """
        q = np.asarray(q)
        if q.ndim != 1 or len(q) < 1:
            raise ValueError("query must be a non-empty 1-D code array")
        if q.min() < 0 or q.max() >= self.dev.base:
            raise ValueError(f"query has codes outside [0, {self.dev.base})")
        w_cap = (self.dev.max_pattern_len // 4) * 4  # pad_batch's cap
        w_req = int(window) if window is not None else w_cap
        if w_req < 1:
            raise ValueError("window must be >= 1")
        w = -(-max(w_req, self.dev.k_route, 4) // 4) * 4  # packing granularity
        if w > w_cap:
            raise ValueError(
                f"window {w} exceeds max_pattern_len={self.dev.max_pattern_len} "
                f"(rounded to {w_cap})")
        b_pad = -(-len(q) // _MS_BATCH_PAD) * _MS_BATCH_PAD
        q_ext = np.full(b_pad + w, self.dev.base - 1, np.int32)
        q_ext[: len(q)] = q
        # dense indexes compare words unless the query carries the
        # terminal (or REPRO_WORD_COMPARE=byte pins the byte-key oracle)
        word = (self.dev.packed and kops._use_word_compare()
                and int(q.max()) < self.dev.s_text.terminal)
        out = _matching_stats(
            self.dev.s_text, self.dev.ell, self.dev.win_lo, self.dev.win_hi,
            self.dev.pows, torch.from_numpy(q_ext).to(self.dev.device),
            len(q), k_route=self.dev.k_route, n_iter=self.dev.n_iter, w=w,
            word=word).cpu().numpy()  # one host sync
        # re-apply the caller's exact cap (w was rounded up to whole words;
        # a witness matching >= ms symbols stays valid after clipping)
        return np.minimum(out[0, : len(q)], w_req), out[1, : len(q)]

    # ---- repeats ----------------------------------------------------------

    def _top_repeats(self, k: int):
        """Top-k LCP entries expanded to maximal repeat intervals
        (``repro.core.analytics._top_repeats``): row i with v = lcp[i] >= 1
        spans the rows jl..jn-1 between the nearest smaller entries, so the
        repeat occurs ``jn - jl`` times.  Returns (v, count, witness, jl,
        jn) as host arrays."""
        total = self.total
        v, i = _top_k(self.lcp, k)
        target = torch.clamp(v, min=1)  # v == 0 rows are filtered by the caller
        jl = rmq.prev_less(self.vals, i, target)
        jn = total - rmq.prev_less(self.vals_rev, total - i, target)
        return tuple(x.cpu().numpy() for x in
                     (v, jn - jl, self.dev.ell[i], jl, jn))

    def top_repeats(self, k: int = 10) -> list[dict]:
        """Up to ``k`` deepest maximal repeat intervals, longest first.

        Each entry: ``length`` (symbols), ``count`` (occurrences),
        ``witness`` (one start position), ``rows`` (the SA row interval
        [lo, hi) of all occurrences).  Ties on the same interval dedupe.
        """
        if k < 1:
            raise ValueError("k must be >= 1")
        # a high-multiplicity repeat contributes MANY equal LCP rows that
        # dedupe to one interval, so the candidate pool grows until k
        # distinct intervals are found or the LCP array is exhausted
        kk = min(self.total, 4 * k)
        while True:
            out, seen = [], set()
            exhausted = False
            for vi, ci, wi, li, ni in zip(*self._top_repeats(kk)):
                if vi <= 0:
                    exhausted = True  # no repeats beyond this point
                    break
                key = (int(li), int(ni))
                if key in seen:
                    continue
                seen.add(key)
                out.append({"length": int(vi), "count": int(ci),
                            "witness": int(wi), "rows": (int(li), int(ni))})
                if len(out) == k:
                    break
            if len(out) == k or exhausted or kk == self.total:
                return out
            kk = min(self.total, 4 * kk)

    def longest_repeat(self) -> dict | None:
        """The longest substring occurring >= 2 times (None if every LCP
        entry is zero)."""
        top = self.top_repeats(1)
        return top[0] if top else None

    # ---- counting ---------------------------------------------------------

    def distinct_substrings(self, *, include_terminal: bool = False) -> int:
        """Number of distinct non-empty substrings: n(n+1)/2 − ΣLCP over the
        n = |S| suffixes (summed in int64).  By default the n substrings
        containing the terminal ``$`` are excluded."""
        n = self.total
        full = n * (n + 1) // 2 - int(self.lcp_host.astype(np.int64).sum())
        return full - n if not include_terminal else full

    # ---- k-mer spectrum ---------------------------------------------------

    def _kmer_spectrum(self, k: int, topk: int):
        """k-mer groups as maximal runs of lcp >= k; counts skip suffixes
        shorter than k (``repro.core.analytics._kmer_spectrum``).
        Returns (counts, rep, top_c, top_pos) on the device."""
        ell = self.dev.ell
        total = self.total
        rows = torch.arange(total, dtype=torch.int32, device=ell.device)
        valid = (ell.to(torch.int64) + k) <= total  # hosts a full k-mer
        gid = torch.cumsum((self.lcp < k).to(torch.int64), 0) - 1
        counts = torch.zeros(total, dtype=torch.int32, device=ell.device)
        counts.index_add_(0, gid, valid.to(torch.int32))
        rep = torch.full((total,), total, dtype=torch.int32, device=ell.device)
        rep.scatter_reduce_(0, gid, torch.where(valid, rows, total),
                            "amin", include_self=True)
        top_c, top_g = _top_k(counts, topk)
        top_pos = ell[torch.clamp(rep[top_g], 0, total - 1)]
        return counts, rep, top_c, top_pos

    def kmer_spectrum(self, k: int):
        """All distinct k-mers of S as ``(starts, counts)``: one witness
        start position and the occurrence count per k-mer (suffixes shorter
        than ``k`` never contribute)."""
        if not 1 <= k <= self.total:
            raise ValueError(f"need 1 <= k <= {self.total}")
        counts, rep, _, _ = self._kmer_spectrum(k, 1)
        counts = counts.cpu().numpy()
        rep = rep.cpu().numpy()
        mask = counts > 0
        starts = self.dev.ell_host[rep[mask]].astype(np.int64)
        return starts, counts[mask].astype(np.int64)

    def top_kmers(self, k: int, topk: int = 10) -> list[dict]:
        """The ``topk`` most frequent k-mers: ``kmer`` (code array),
        ``count``, ``witness`` (one start position)."""
        if not 1 <= k <= self.total:
            raise ValueError(f"need 1 <= k <= {self.total}")
        tk = min(int(topk), self.total)
        _, _, top_c, top_pos = self._kmer_spectrum(k, tk)
        # read the (topk, k) windows on the device, not the whole string
        wins = self.dev.read_symbols(top_pos, k).cpu().numpy()
        out = []
        for c, p, w in zip(top_c.cpu().numpy(), top_pos.cpu().numpy(), wins):
            if c <= 0:
                break
            out.append({"kmer": w.copy(), "count": int(c), "witness": int(p)})
        return out

"""Device-resident batched query engine — PyTorch port of ``repro.core.query``.

:class:`DeviceIndex` holds the flattened index on the device: ``ell`` (the
concatenated leaf arrays in prefix order, i.e. the suffix array), the
per-sub-tree tables, and a dense top-trie routing table at depth
``k_route``.  :meth:`DeviceIndex.find_batch_ranges` resolves a whole
``(B, m)`` batch with one routing gather and a fixed-trip lower/upper
bound binary search (the JAX ``fori_loop``), which runs as ONE search
kernel launch per batch: each row walks its routed window and stops once
it is empty.  The search follows the served string, as in the JAX
package:

* a dense :class:`repro_torch.core.packing.PackedText` —
  ``search_bounds_words`` on dense pattern words, or, for a batch that
  carries the terminal code, a loop of ``pattern_probe_packed`` steps on
  byte keys (``n_iter`` launches);
* the terminal-padded uint8 byte string (protein, english, byte, or
  ``packing="bytes"``) — ``search_bounds_bytes`` on byte keys.

:meth:`DeviceIndex.find_fetch_ranges` adds the find-and-fetch epilogue
(the verdict and the text at each pattern's lower-bound suffix) to the
same launch: ONE ``search_fetch_words`` / ``search_fetch_bytes`` launch
per batch on dense words / the byte string; byte keys on dense text run
their loop, then one ``probe_gather_packed`` launch and the decode.  :class:`RouteCache` memoizes results by
:meth:`DeviceIndex.route_key` for :meth:`DeviceIndex.find_batch_cached` and
the serving loop (:mod:`repro_torch.launch.serving`).

Archives keep the JAX package's npz layouts (dense ``s_words`` with a
7-entry meta, byte ``s_padded`` with the 4-entry meta plus the epoch), so
indexes load in both directions.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch.core import packing as packing_mod
from repro_torch.kernels import ops as kops


def npz_path(path: str) -> str:
    """The path ``np.savez_compressed`` actually writes (``.npz`` appended)."""
    return path if path.endswith(".npz") else path + ".npz"


def route_depth(base: int, max_plen: int, route_cap: int) -> int:
    """Depth of the dense top-trie routing table: the deepest ``k`` with
    ``base**k`` cells under ``route_cap`` (and within the shallowest
    prefix)."""
    k_route = 1
    while base ** (k_route + 1) <= route_cap and k_route < max_plen:
        k_route += 1
    return k_route


def _pack_query_batch(s_text, patterns: torch.Tensor, lengths: torch.Tensor,
                      word: bool = True):
    """Pattern packing (once per batch): zero symbols past each length in
    both the pattern and its mask, so masked suffix words compare against
    exactly the first ``m`` symbols.  Word path: ``bits``-wide fields over
    dense words; byte path: 0xFF-byte masks over 4-symbol key words."""
    m_pad = patterns.shape[1]
    in_pat = (torch.arange(m_pad, device=patterns.device)[None, :]
              < lengths[:, None])
    if not word:
        return (packing_mod.pack_words(torch.where(in_pat, patterns, 0)),
                packing_mod.pack_words(torch.where(in_pat, 0xFF, 0)))
    bits = s_text.bits
    pat_words = packing_mod.pack_pattern_dense(
        torch.where(in_pat, patterns, 0), bits, s_text.terminal)
    mask_words = packing_mod.pack_dense(
        torch.where(in_pat, (1 << bits) - 1, 0), bits)
    return pat_words, mask_words


def _route_window(win_lo, win_hi, pows, spans, lengths, route_syms,
                  k_route: int):
    """Routing: one gather into the dense table bounds the binary search
    to the slice of ``ell`` owned by the pattern's depth-k_route cells."""
    k = torch.clamp(lengths, max=k_route)
    in_route = (torch.arange(k_route, device=lengths.device)[None, :]
                < k[:, None])
    c_lo = torch.sum(torch.where(in_route, route_syms, 0) * pows[None, :],
                     dim=1)
    c_hi = c_lo + spans[k.to(torch.int64)]
    lo0 = win_lo[c_lo]
    hi0 = torch.maximum(win_hi[c_hi], lo0)
    return lo0, hi0


@dataclasses.dataclass(frozen=True)
class DeviceIndex:
    """Flattened, device-resident index."""

    base: int                 # |Σ| + 1 including the terminal
    k_route: int              # routing-trie depth (base**k_route cells)
    n_iter: int               # binary-search trip count (covers ``total``)
    max_pattern_len: int      # padding guarantee baked into ``s_text``
    s_text: packing_mod.PackedText | torch.Tensor  # dense words | uint8 bytes
    ell: torch.Tensor         # int32[total] concatenated leaf arrays (= SA)
    ell_host: np.ndarray      # host copy of ell (result materialization)
    sub_off: torch.Tensor     # int32[T] slice start of sub-tree t in ell
    sub_freq: torch.Tensor    # int32[T]
    sub_prefix: torch.Tensor  # int32[T, max_plen] prefix symbols, -1 pad
    sub_plen: torch.Tensor    # int32[T]
    win_lo: torch.Tensor      # int32[base**k_route] routing slice starts
    win_hi: torch.Tensor      # int32[base**k_route] routing slice ends
    pows: torch.Tensor        # int32[k_route] base**(k_route-1-j)
    spans: torch.Tensor       # int32[k_route+1] base**(k_route-k) - 1
    epoch: int = 0            # mutation generation (kept for archives)

    @property
    def n_leaves(self) -> int:
        return int(self.ell.shape[0])

    @property
    def n_subtrees(self) -> int:
        return int(self.sub_off.shape[0])

    @property
    def device(self) -> torch.device:
        return self.ell.device

    @property
    def packed(self) -> bool:
        """True when the string is stored dense (k-bit PackedText)."""
        return isinstance(self.s_text, packing_mod.PackedText)

    @property
    def s_bits(self) -> int:
        """Stored bits per symbol (8 on the byte path)."""
        return self.s_text.bits if self.packed else 8

    @property
    def s_padded(self) -> torch.Tensor:
        """The terminal-padded uint8 string (byte-path indexes only)."""
        if self.packed:
            raise AttributeError(
                "this DeviceIndex stores the string dense-packed; use "
                "s_text / read_symbols / string_codes")
        return self.s_text

    @property
    def string_nbytes(self) -> int:
        """Bytes the served string representation occupies."""
        return (self.s_text.nbytes if self.packed
                else int(self.s_text.shape[0]))

    def read_symbols(self, pos, k: int) -> torch.Tensor:
        """(B, k) int32 symbol codes starting at each position, on the
        device, whatever the storage (the terminal past the end)."""
        pos = torch.as_tensor(pos, dtype=torch.int32, device=self.device)
        if self.packed:
            return packing_mod.gather_symbols_dense(self.s_text, pos, k)
        idx = (pos.to(torch.int64)[:, None]
               + torch.arange(k, device=self.device)[None, :])
        idx = torch.clamp(idx, max=self.s_text.shape[0] - 1)
        return self.s_text[idx].to(torch.int32)

    def string_codes(self) -> np.ndarray:
        """The indexed string back as uint8 codes (terminal included)."""
        if self.packed:
            return packing_mod.unpack_text(self.s_text, n=self.n_leaves)
        return self.s_text[: self.n_leaves].cpu().numpy()

    # ---- construction -----------------------------------------------------

    @classmethod
    def from_index(cls, index, *, route_cap: int = 1 << 18,
                   max_pattern_len: int = 512, packing: str = "auto",
                   device=None) -> "DeviceIndex":
        """Flatten a :class:`repro_torch.core.suffix_tree.SuffixTreeIndex`
        (``repro.core.query.DeviceIndex.from_index``) onto ``device``
        (default: the index's own device)."""
        prefixes = sorted(index.subtrees)
        if not prefixes:
            raise ValueError("cannot flatten an empty index")
        subs = [index.subtrees[p] for p in prefixes]
        freqs = np.array([st.freq for st in subs], np.int32)
        ell = np.concatenate([np.asarray(st.ell, np.int32) for st in subs])
        return cls.from_prepare(alphabet=index.alphabet, s=np.asarray(index.s),
                                prefixes=prefixes, freqs=freqs,
                                ell=torch.from_numpy(ell),
                                route_cap=route_cap,
                                max_pattern_len=max_pattern_len,
                                packing=packing,
                                device=index.device if device is None
                                else device)

    @classmethod
    def from_prepare(cls, *, alphabet, s: np.ndarray, prefixes, freqs,
                     ell, route_cap: int = 1 << 18,
                     max_pattern_len: int = 512,
                     packing: str = "auto",
                     k_route: int | None = None,
                     epoch: int = 0, device="cuda") -> "DeviceIndex":
        """Assemble from construction output: sorted prefix tuples, their
        leaf counts and the concatenated leaf arrays (a device tensor from
        the batched engine stays on the device; the routing tables are
        computed on the host from the prefix metadata)."""
        dev = kops.resolve_device(device)
        base = alphabet.base
        if not prefixes:
            raise ValueError("cannot flatten an empty index")
        freqs = np.asarray(freqs, np.int32)
        offs = np.concatenate([[0], np.cumsum(freqs)[:-1]]).astype(np.int32)
        total = int(freqs.sum())

        max_plen = max(len(p) for p in prefixes)
        plen = np.array([len(p) for p in prefixes], np.int32)
        pref = np.full((len(prefixes), max_plen), -1, np.int32)
        for t, p in enumerate(prefixes):
            pref[t, : len(p)] = p

        if k_route is None:
            k_route = route_depth(base, max_plen, route_cap)
        n_cells = base**k_route

        # each sub-tree owns the depth-k_route code interval [clo, chi] of
        # its (truncated) prefix; prefix-freeness keeps them sorted
        clo = np.zeros(len(prefixes), np.int64)
        chi = np.zeros(len(prefixes), np.int64)
        for t, p in enumerate(prefixes):
            kk = min(len(p), k_route)
            c = 0
            for j in range(kk):
                c = c * base + p[j]
            clo[t] = c * base ** (k_route - kk)
            chi[t] = clo[t] + base ** (k_route - kk) - 1
        codes = np.arange(n_cells, dtype=np.int64)
        off_ext = np.concatenate([offs, [total]]).astype(np.int32)
        win_lo = off_ext[np.searchsorted(chi, codes, side="left")]
        t_last = np.searchsorted(clo, codes, side="right") - 1
        win_hi = np.where(t_last >= 0, offs[np.maximum(t_last, 0)]
                          + freqs[np.maximum(t_last, 0)], 0).astype(np.int32)

        n_iter = int(np.ceil(np.log2(total + 1))) + 1
        pows = (base ** np.arange(k_route - 1, -1, -1)).astype(np.int32)
        spans = (base ** (k_route - np.arange(k_route + 1)) - 1).astype(np.int32)
        if packing_mod.resolve_dense(packing, alphabet):
            s_text = packing_mod.pack_text(np.asarray(s), alphabet,
                                           extra=max_pattern_len + 8,
                                           device=dev)
        else:  # the served padding contract: max_pattern_len + 8 (C6)
            s_text = torch.from_numpy(alphabet.pad_string(
                np.asarray(s), extra=max_pattern_len + 8)).to(dev)
        ell_dev = torch.as_tensor(ell).to(device=dev, dtype=torch.int32)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return cls(
            base=base, k_route=k_route, n_iter=n_iter,
            max_pattern_len=max_pattern_len, s_text=s_text,
            ell=ell_dev, ell_host=ell_dev.cpu().numpy(),
            sub_off=t(offs), sub_freq=t(freqs), sub_prefix=t(pref),
            sub_plen=t(plen), win_lo=t(win_lo), win_hi=t(win_hi),
            pows=t(pows), spans=t(spans), epoch=int(epoch),
        )

    # ---- persistence (the JAX package's npz layout) -------------------------

    _BLOB_FIELDS = ("ell", "sub_off", "sub_freq", "sub_prefix",
                    "sub_plen", "win_lo", "win_hi", "pows", "spans")

    def to_blobs(self) -> dict[str, np.ndarray]:
        """The JAX package's blobs (hazard C8): a dense index writes
        ``s_words`` (uint32) and the meta ``[base, k_route, n_iter,
        max_pattern_len, s_bits, n_real, epoch]``; a byte index writes
        ``s_padded`` (uint8) and ``[base, k_route, n_iter,
        max_pattern_len, epoch]``."""
        meta = [self.base, self.k_route, self.n_iter, self.max_pattern_len]
        if self.packed:
            meta += [self.s_text.bits, self.s_text.n_real]
            blobs = {"s_words": self.s_text.words_numpy()}
        else:
            blobs = {"s_padded": self.s_text.cpu().numpy()}
        meta.append(self.epoch)
        blobs["meta"] = np.array(meta, np.int64)
        for name in self._BLOB_FIELDS:
            blobs[name] = getattr(self, name).cpu().numpy()
        return blobs

    @classmethod
    def from_blobs(cls, data, device="cuda") -> "DeviceIndex":
        """Restore from :meth:`to_blobs` output or from the JAX package's
        ``DeviceIndex.to_blobs()``, either layout; archives written before
        epochs existed load as epoch 0."""
        dev = kops.resolve_device(device)
        meta = np.asarray(data["meta"])
        if "s_words" in data:
            s_text = packing_mod.PackedText.from_numpy(
                np.asarray(data["s_words"]), int(meta[5]), int(meta[4]),
                int(meta[0]) - 1, dev)
            epoch = int(meta[6]) if meta.size > 6 else 0
        else:  # byte-format archive
            s_text = torch.from_numpy(
                np.array(data["s_padded"], np.uint8)).to(dev)
            epoch = int(meta[4]) if meta.size > 4 else 0
        fields = {name: torch.from_numpy(np.array(data[name], np.int32)).to(dev)
                  for name in cls._BLOB_FIELDS}
        return cls(base=int(meta[0]), k_route=int(meta[1]), n_iter=int(meta[2]),
                   max_pattern_len=int(meta[3]), s_text=s_text,
                   ell_host=np.asarray(data["ell"], np.int32), epoch=epoch,
                   **fields)

    def save(self, path: str) -> None:
        """Persist the flattened index (npz); ``load`` restores it exactly."""
        np.savez_compressed(npz_path(path), **self.to_blobs())

    @classmethod
    def load(cls, path: str, device="cuda") -> "DeviceIndex":
        with np.load(npz_path(path)) as data:
            return cls.from_blobs(data, device=device)

    # ---- queries ----------------------------------------------------------

    def pad_batch(self, patterns, *, m_pad: int | None = None,
                  b_pad: int | None = None,
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Pad a list of 1-D code arrays to (B, m_pad) + lengths + route
        rows (host numpy), exactly as the JAX ``pad_batch`` does."""
        if not len(patterns):
            raise ValueError("empty batch")
        lengths = np.array([len(p) for p in patterns], np.int32)
        if (lengths < 1).any():
            raise ValueError("patterns must have length >= 1")
        m_max = int(lengths.max())
        m_nat = -(-m_max // 4) * 4
        if m_pad is None:
            m_pad = m_nat
        elif m_pad % 4 or m_pad < m_nat:
            raise ValueError(
                f"m_pad={m_pad} must be a multiple of 4 and >= {m_nat}")
        if m_pad > self.max_pattern_len:
            raise ValueError(
                f"pattern length {m_max} exceeds max_pattern_len="
                f"{self.max_pattern_len}; rebuild with a larger max_pattern_len")
        b = len(patterns)
        if b_pad is None:
            b_pad = b
        elif b_pad < b:
            raise ValueError(f"b_pad={b_pad} < batch size {b}")
        padded = np.zeros((b_pad, m_pad), np.int32)
        route = np.zeros((b_pad, self.k_route), np.int32)
        for i, p in enumerate(patterns):
            arr = np.asarray(p, np.int32)
            if arr.size and (arr.min() < 0 or arr.max() >= self.base):
                raise ValueError(f"pattern {i} has codes outside [0, {self.base})")
            padded[i, : len(arr)] = arr
            route[i, : min(len(arr), self.k_route)] = arr[: self.k_route]
        if b_pad > b:
            lengths = np.concatenate(
                [lengths, np.ones(b_pad - b, np.int32)])
        return padded, lengths, route

    def _word_gate(self, patterns, pat_max: int | None) -> bool:
        """Word probe or byte-key probe for this batch (as the JAX
        ``_word_gate``): a byte text always takes the byte-key probe; a
        dense text takes the word probe unless the batch carries the
        terminal code, whose verdicts only the byte-key probe defines, or
        ``REPRO_WORD_COMPARE=byte`` pins the byte-key oracle.
        ``pat_max``, when the caller knows it, spares the device reduce."""
        if not (self.packed and kops._use_word_compare()):
            return False
        if pat_max is None:
            if isinstance(patterns, torch.Tensor):
                pat_max = int(patterns.max()) if patterns.numel() else 0
            else:
                pat_max = int(np.asarray(patterns).max(initial=0))
        return pat_max < self.s_text.terminal

    def _pack_route(self, patterns, lengths, route_syms, pat_max):
        """Pack and route a padded batch on the device; returns ``(word,
        pat_words, mask_words, lengths, lo0, hi0)``.  Inputs already on the
        device as int32 (the serving loop's uploads) are used as they
        are."""
        word = self._word_gate(patterns, pat_max)
        patterns, lengths, route_syms = (
            torch.as_tensor(a, dtype=torch.int32, device=self.device)
            for a in (patterns, lengths, route_syms))
        pat_words, mask_words = _pack_query_batch(self.s_text, patterns,
                                                  lengths, word)
        lo0, hi0 = _route_window(self.win_lo, self.win_hi, self.pows,
                                 self.spans, lengths, route_syms, self.k_route)
        return word, pat_words, mask_words, lengths, lo0, hi0

    def find_batch_ranges(self, patterns, lengths, route_syms,
                          *, pat_max: int | None = None):
        """(B, m_pad)/(B,)/(B, k_route) → (start, count) int32 slices of
        ``ell`` on the device (matches are ``ell[start:start+count]``).
        Pass the batch's ``pat_max`` when it is known: the probe gate then
        needs no device reduce, and device inputs make the call sync-free."""
        word, pat, mask, lengths, lo0, hi0 = self._pack_route(
            patterns, lengths, route_syms, pat_max)
        llo, ulo = kops.search_bounds(self.s_text, self.ell, pat, mask,
                                      lengths, None, lo0, hi0,
                                      n_iter=self.n_iter, bounds=2, word=word)
        return llo, torch.clamp(ulo - llo, min=0)

    def find_fetch_ranges(self, patterns, lengths, route_syms, *, fetch: int,
                          pat_max: int | None = None):
        """Find-and-fetch: :meth:`find_batch_ranges` plus ``fetch`` symbols
        of text at the first (suffix-array order) match, from the same
        search launch (:func:`repro_torch.kernels.ops.search_fetch`).
        Returns device tensors ``(start, count, window, verified)``;
        window is (B, fetch) int32 codes (−1 rows where count == 0),
        verified the fused verdict (0 where count > 0)."""
        if fetch % 4 or fetch <= 0:
            raise ValueError(f"fetch={fetch} must be a positive multiple of 4")
        if fetch > self.max_pattern_len:
            raise ValueError(
                f"fetch={fetch} exceeds max_pattern_len={self.max_pattern_len}"
                " (the gather-past-|S| padding guarantee)")
        word, pat, mask, lengths, lo0, hi0 = self._pack_route(
            patterns, lengths, route_syms, pat_max)
        return kops.search_fetch(self.s_text, self.ell, pat, mask, lengths,
                                 lo0, hi0, n_iter=self.n_iter, fetch=fetch,
                                 word=word)

    def positions(self, start: int, count: int) -> np.ndarray:
        """The sorted int64 occurrence positions ``ell[start:start+count]``
        (from the host copy of ``ell``: no device copy per batch)."""
        pos = self.ell_host[start : start + count].astype(np.int64)
        pos.sort()
        return pos

    def find_batch(self, patterns) -> list[np.ndarray]:
        """All occurrence positions for each pattern (sorted, int64)."""
        padded, lengths, route = self.pad_batch(patterns)
        start, count = self.find_batch_ranges(padded, lengths, route)
        return [self.positions(s, c)
                for s, c in zip(start.tolist(), count.tolist())]

    def find_fetch_batch(self, patterns, *, fetch: int = 32):
        """Host convenience find-and-fetch over a list of code arrays:
        ``(ranges, windows)`` — the sorted occurrence positions per pattern
        (as :meth:`find_batch`) and a (B, fetch) int32 array of the text at
        each pattern's first (suffix-array order) match, −1 rows for
        patterns that do not occur."""
        padded, lengths, route = self.pad_batch(patterns)
        start, count, win, _ = self.find_fetch_ranges(padded, lengths, route,
                                                      fetch=fetch)
        ranges = [self.positions(s, c)
                  for s, c in zip(start.tolist(), count.tolist())]
        return ranges, win.cpu().numpy()

    # ---- hot-prefix route cache -------------------------------------------

    def route_key(self, pattern) -> tuple[int, int, bytes]:
        """Cache key of one pattern: ``(route code, length, bytes)``
        (``repro.core.query.DeviceIndex.route_key``).  The route code is the
        depth-``k_route`` cell :func:`_route_window` gathers, so keys
        cluster by the route a query takes; the pattern bytes keep lookups
        exact (verdicts do not depend on the padded width)."""
        arr = np.asarray(pattern, np.int32)
        kk = min(arr.size, self.k_route)
        c = 0
        for j in range(kk):
            c = c * self.base + int(arr[j])
        c *= self.base ** (self.k_route - kk)
        return c, arr.size, arr.tobytes()

    def find_batch_cached(self, patterns, cache: "RouteCache") -> list[np.ndarray]:
        """:meth:`find_batch` through a :class:`RouteCache`: hits resolve to
        their memoized ``(start, count)`` without the device; the misses run
        as one smaller batch (a pattern repeated in the batch costs one
        row) and fill the cache.  Results equal :meth:`find_batch`."""
        keys = [self.route_key(p) for p in patterns]
        bounds = [cache.get(k) for k in keys]
        miss: dict[tuple, int] = {}
        for i, bnd in enumerate(bounds):
            if bnd is None and keys[i] not in miss:
                miss[keys[i]] = i
        if miss:
            padded, lengths, route = self.pad_batch(
                [patterns[i] for i in miss.values()])
            start, count = self.find_batch_ranges(padded, lengths, route)
            solved = dict(zip(miss, zip(start.tolist(), count.tolist())))
            for k, bnd in solved.items():
                cache.put(k, bnd)
            bounds = [solved[k] if bnd is None else bnd
                      for k, bnd in zip(keys, bounds)]
        return [self.positions(s, c) for s, c in bounds]


class RouteCache:
    """LRU memo of route-keyed patterns → their bounds (or any value the
    caller stores, such as the serving loop's materialized results), with
    hit, miss and eviction counters (``repro.core.query.RouteCache``).
    Exact-pattern keys make results with and without the cache equal."""

    def __init__(self, capacity: int = 4096):
        if capacity < 0:
            raise ValueError(f"capacity={capacity} must be >= 0")
        self.capacity = capacity
        self._map: collections.OrderedDict = collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._map)

    def get(self, key):
        if self.capacity == 0:
            self.misses += 1
            return None
        got = self._map.get(key)
        if got is None:
            self.misses += 1
            return None
        self._map.move_to_end(key)
        self.hits += 1
        return got

    def put(self, key, value) -> None:
        if self.capacity == 0:
            return
        if key in self._map:
            self._map.move_to_end(key)
        self._map[key] = value
        while len(self._map) > self.capacity:
            self._map.popitem(last=False)
            self.evictions += 1

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {"size": len(self._map), "capacity": self.capacity,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "hit_rate": self.hit_rate}

    def clear(self) -> None:
        self._map.clear()

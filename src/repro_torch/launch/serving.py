"""Async continuous-batching serving stack — PyTorch port of
``repro.launch.serving`` (the single-index backend).

:mod:`repro_torch.launch.query_serve` measures the engine: pre-padded
batches through ``find_batch_ranges``, one at a time, blocking on every
call.  This module is the tier users put in front of a
:class:`repro_torch.core.query.DeviceIndex`:

* **Admission queue and continuous batch coalescing** — requests queue up
  (bounded depth, rejects counted) and the server drains up to
  ``max_batch`` of them into the next padded batch, pad width and batch
  rows bucketed to powers of two; a partial batch is held open until its
  oldest request has waited ``max_wait_ms``.
* **Overlapped host/device pipeline** — batch k+1 is dispatched before
  batch k is consumed.  On the card a dispatch puts the padded rows in
  pinned host memory, copies them to the device with ``non_blocking``,
  launches the search (with ``pat_max`` known, so no device reduce), copies
  ``start``, ``count`` (and the window) back into pinned host tensors with
  ``non_blocking`` and records a CUDA event; consuming a batch waits on
  that batch's event and nothing else, so it never waits for the kernels
  of the batch dispatched after it.  No call in a dispatch synchronises
  the host with the card.  ``pipeline=False`` is the synchronous
  one-batch-at-a-time baseline.  On the CPU the same code runs
  synchronously (no pinning, no events).
* **Hot-prefix route cache** — a :class:`repro_torch.core.query.RouteCache`
  keyed on :meth:`DeviceIndex.route_key` resolves repeated patterns at
  admission, before they cost a batch row; it fills when a batch is
  consumed.  Exact-pattern keys keep results with and without it equal.
* **Find-and-fetch** — ``fetch`` > 0 returns, with each match, ``fetch``
  symbols of text read by the fused probe + gather kernel.

Every :class:`ServeConfig` field defaults from a ``REPRO_SERVE_*``
variable, with the JAX package's names and defaults.  The sharded backend
(``--shards``) waits for the port's fabric (ROADMAP A12) and the spans,
metrics and ``--metrics-port`` for its tracing (A16); ``stats()`` reports
every counter the JAX server reports.

  PYTHONPATH=src python -m repro_torch.launch.serving --dataset dna \\
      --n 100000 --requests 4096 --mode all        # --device cpu: plain path
"""

from __future__ import annotations

import argparse
import collections
import os
import time

import numpy as np
import torch

from repro_torch.core.api import EraConfig, EraIndexer
from repro_torch.core.query import DeviceIndex, RouteCache
from repro_torch.launch.warmstart import load_or_build


class ServeConfig:
    """Serving knobs; each field defaults from a ``REPRO_SERVE_*`` variable
    and keyword overrides win:

    * ``queue_depth`` — admission queue capacity; arrivals past it are
      rejected and counted [REPRO_SERVE_QUEUE_DEPTH=1024]
    * ``max_batch`` — most requests coalesced into one padded batch
      [REPRO_SERVE_MAX_BATCH=256]
    * ``max_wait_ms`` — batch aging: a partial batch waits for more
      arrivals until its oldest request has waited this long
      [REPRO_SERVE_MAX_WAIT_MS=1.0]
    * ``cache_size`` — route-cache entries, 0 disables [REPRO_SERVE_CACHE=4096]
    * ``fetch`` — text symbols returned per match by the fused probe +
      gather kernel; 0 returns positions only [REPRO_SERVE_FETCH=0]
    * ``pipeline`` — overlap the dispatch of batch k+1 with the consume of
      batch k; 0 is the synchronous baseline [REPRO_SERVE_PIPELINE=1]
    """

    def __init__(self, **overrides):
        env = os.environ.get
        self.queue_depth = int(env("REPRO_SERVE_QUEUE_DEPTH", "1024"))
        self.max_batch = int(env("REPRO_SERVE_MAX_BATCH", "256"))
        self.max_wait_ms = float(env("REPRO_SERVE_MAX_WAIT_MS", "1.0"))
        self.cache_size = int(env("REPRO_SERVE_CACHE", "4096"))
        self.fetch = int(env("REPRO_SERVE_FETCH", "0"))
        self.pipeline = bool(int(env("REPRO_SERVE_PIPELINE", "1")))
        for key, val in overrides.items():
            if not hasattr(self, key):
                raise TypeError(f"unknown ServeConfig field {key!r}")
            setattr(self, key, val)
        if self.queue_depth < 1 or self.max_batch < 1:
            raise ValueError("queue_depth and max_batch must be >= 1")
        if self.fetch and (self.fetch % 4 or self.fetch < 0):
            raise ValueError(f"fetch={self.fetch} must be 0 or a positive "
                             "multiple of 4")


class _Request:
    __slots__ = ("rid", "pattern", "pat_max", "t_admit")

    def __init__(self, rid, pattern, t_admit):
        self.rid = rid
        self.pattern = np.asarray(pattern, np.int32)
        self.pat_max = int(self.pattern.max(initial=0))
        self.t_admit = t_admit


class _InFlight:
    """One dispatched batch: its requests and their rows, the cache hits
    resolved at admission, and the host tensors its results land in
    (``ready``, the CUDA event recorded after their copies, is None on the
    CPU)."""

    __slots__ = ("requests", "keys", "row_of", "hit_vals", "n_rows", "out",
                 "ready")

    def __init__(self, requests, keys, row_of, hit_vals, n_rows):
        self.requests = requests
        self.keys = keys
        self.row_of = row_of      # per-request batch row; None = cache hit
        self.hit_vals = hit_vals
        self.n_rows = n_rows      # real rows before the b_pad padding
        self.out = ()             # (start, count[, window]) host tensors
        self.ready = None


def _frozen(*arrays) -> tuple:
    """The arrays made read-only: one result may serve many requests."""
    for a in arrays:
        if a is not None:
            a.flags.writeable = False
    return arrays


def _single_index(dev) -> None:
    if hasattr(dev, "shards"):
        raise NotImplementedError(
            "the sharded serving backend is not ported yet (ROADMAP A12); "
            "serve a DeviceIndex")


class AsyncServer:
    """Continuous-batching server over a :class:`DeviceIndex`.

    A single-threaded loop: :meth:`submit` admits requests; :meth:`pump`
    (or :meth:`serve`) coalesces a batch, dispatches it without blocking and
    consumes the previous batch while the new one runs.  Each request's
    result is ``(positions, window)``: its sorted int64 occurrence
    positions and, when ``config.fetch`` > 0, the (fetch,) int32 text at
    its first suffix-array-order match (else None), both read-only.
    """

    def __init__(self, dev: DeviceIndex, config: ServeConfig | None = None):
        _single_index(dev)
        self.dev = dev
        self.config = config or ServeConfig()
        self.cache = RouteCache(self.config.cache_size)
        self.queue: collections.deque[_Request] = collections.deque()
        self.inflight: _InFlight | None = None
        self.results: dict[int, tuple] = {}
        self.latency_s: list[float] = []
        self.n_admitted = 0
        self.n_rejected = 0
        self.n_batches = 0
        self.n_rows_padded = 0
        self.shapes: set[tuple[int, int]] = set()
        self.n_index_swaps = 0
        self._width_cap = max(4, dev.max_pattern_len - dev.max_pattern_len % 4)

    # ---- admission --------------------------------------------------------

    def submit(self, rid, pattern, now: float | None = None) -> bool:
        """Admit one request; False (and a count) when the queue is full."""
        if len(self.queue) >= self.config.queue_depth:
            self.n_rejected += 1
            return False
        self.queue.append(_Request(rid, pattern,
                                   time.perf_counter() if now is None else now))
        self.n_admitted += 1
        return True

    # ---- batching ---------------------------------------------------------

    def _bucket_width(self, m_nat: int) -> int:
        w = 4
        while w < m_nat:
            w *= 2
        return min(w, self._width_cap)

    def _bucket_rows(self, b: int) -> int:
        r = 1
        while r < b:
            r *= 2
        return min(r, self.config.max_batch)

    def _take_batch(self) -> list[_Request] | None:
        """Pop up to ``max_batch`` requests; a partial batch is held open
        (None) until its oldest request has waited ``max_wait_ms``."""
        if not self.queue:
            return None
        cfg = self.config
        oldest_age_ms = (time.perf_counter() - self.queue[0].t_admit) * 1e3
        if len(self.queue) < cfg.max_batch and oldest_age_ms < cfg.max_wait_ms:
            return None
        return [self.queue.popleft()
                for _ in range(min(len(self.queue), cfg.max_batch))]

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host batch array on the index's device: pinned, then copied
        without blocking the host."""
        t = torch.from_numpy(a)
        if self.dev.device.type != "cuda":
            return t
        return t.pin_memory().to(self.dev.device, non_blocking=True)

    def _download(self, flight: _InFlight, outs, n_rows: int) -> None:
        """Start the copies of a batch's results to the host: fresh pinned
        tensors (never reused while a copy may be in flight), then one event
        for the consume to wait on."""
        if self.dev.device.type != "cuda":
            flight.out = tuple(t[:n_rows] for t in outs)
            return
        host = []
        for t in outs:
            h = torch.empty(t[:n_rows].shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t[:n_rows], non_blocking=True)
            host.append(h)
        flight.out = tuple(host)
        flight.ready = torch.cuda.Event()
        flight.ready.record()

    def _dispatch(self) -> _InFlight | None:
        """Coalesce up to ``max_batch`` queued requests into one padded
        batch and dispatch it without blocking.  Cache hits resolve here
        (no batch row); with the cache on, a pattern repeated in the batch
        shares one row."""
        requests = self._take_batch()
        if requests is None:
            return None
        cfg = self.config
        keys = [self.dev.route_key(r.pattern) for r in requests]
        # with the cache OFF every request takes its own row (the honest
        # baseline); the cache brings the cross-batch memo and the in-batch
        # sharing of repeated patterns
        caching = cfg.cache_size > 0
        row_of: list[int | None] = []
        key_row: dict[tuple, int] = {}
        miss_req: list[_Request] = []
        hit_vals: dict[tuple, tuple] = {}
        for req, key in zip(requests, keys):
            if caching:
                if key in hit_vals:
                    row_of.append(None)
                    continue
                if key in key_row:
                    row_of.append(key_row[key])
                    continue
                val = self.cache.get(key)
                if val is not None:
                    hit_vals[key] = val
                    row_of.append(None)
                    continue
                key_row[key] = len(miss_req)
            row_of.append(len(miss_req))
            miss_req.append(req)

        flight = _InFlight(requests, keys, row_of, hit_vals, len(miss_req))
        if miss_req:
            pats = [r.pattern for r in miss_req]
            m_pad = self._bucket_width(-(-max(len(p) for p in pats) // 4) * 4)
            b_pad = self._bucket_rows(len(miss_req))
            padded, lengths, route = self.dev.pad_batch(
                pats, m_pad=m_pad, b_pad=b_pad)
            self.shapes.add((m_pad, b_pad))
            self.n_rows_padded += b_pad
            padded, lengths, route = (self._upload(a)
                                      for a in (padded, lengths, route))
            pat_max = max(r.pat_max for r in miss_req)
            if cfg.fetch:
                outs = self.dev.find_fetch_ranges(
                    padded, lengths, route, fetch=cfg.fetch,
                    pat_max=pat_max)[:3]
            else:
                outs = self.dev.find_batch_ranges(padded, lengths, route,
                                                  pat_max=pat_max)
            self._download(flight, outs, len(miss_req))
        self.n_batches += 1
        return flight

    def _consume(self, flight: _InFlight) -> None:
        """Wait for one batch's results (its own event only) and hand them
        to its requests; misses fill the cache with the materialized result.
        Rows with the same bounds share one materialized result (a hot
        pattern repeated in a batch without the cache is sorted once), so
        results are read-only arrays."""
        cfg = self.config
        if flight.ready is not None:
            flight.ready.synchronize()
        if flight.n_rows:
            start = flight.out[0].numpy()
            count = flight.out[1].numpy()
            win = flight.out[2].numpy() if cfg.fetch else None
        done: dict[int, tuple] = {}
        by_bounds: dict[tuple[int, int], tuple] = {}
        caching = cfg.cache_size > 0
        now = time.perf_counter()
        for req, key, row in zip(flight.requests, flight.keys,
                                 flight.row_of):
            if row is None:
                val = flight.hit_vals[key]
            elif row in done:  # a repeat sharing its pattern's row
                val = done[row]
            else:
                bnd = (int(start[row]), int(count[row]))
                val = by_bounds.get(bnd)
                if val is None:
                    val = by_bounds[bnd] = _frozen(
                        self.dev.positions(*bnd),
                        win[row].copy() if cfg.fetch else None)
                done[row] = val
                if caching:
                    self.cache.put(key, val)
            self.results[req.rid] = val
            self.latency_s.append(now - req.t_admit)

    # ---- live index swap --------------------------------------------------

    def update_index(self, dev) -> dict:
        """Swap in a new index generation without dropping queued
        requests: the in-flight batch (dispatched against the old index)
        is consumed first; the route cache is flushed when the ``epoch``
        changes and kept on a same-epoch swap (a replica of the same
        index)."""
        _single_index(dev)
        if self.inflight is not None:
            self._consume(self.inflight)
            self.inflight = None
        old_epoch = int(getattr(self.dev, "epoch", 0))
        new_epoch = int(getattr(dev, "epoch", 0))
        self.dev = dev
        flushed = new_epoch != old_epoch
        if flushed:
            self.cache.clear()
        self._width_cap = max(4, dev.max_pattern_len - dev.max_pattern_len % 4)
        self.n_index_swaps += 1
        return {"epoch": new_epoch, "flushed": flushed, "shards": 1}

    # ---- the serving loop -------------------------------------------------

    def pump(self) -> bool:
        """One loop turn: dispatch the next batch, then consume the previous
        one.  False means the loop is idle (empty, or holding a partial
        batch open for aging)."""
        nxt = self._dispatch()
        did = nxt is not None
        if self.inflight is not None:
            self._consume(self.inflight)
            did = True
        self.inflight = nxt
        if nxt is not None and not self.config.pipeline:
            self._consume(nxt)
            self.inflight = None
        return did

    def drain(self) -> None:
        """Run the loop until the queue and the pipeline are empty."""
        while self.queue or self.inflight is not None:
            if not self.pump():
                time.sleep(50e-6)  # holding a partial batch for aging

    def serve(self, patterns) -> list[tuple]:
        """Closed loop: admit ``patterns`` as fast as the queue allows, pump
        until done, return the results in input order."""
        base = self.n_admitted + self.n_rejected
        i = 0
        while i < len(patterns) or self.queue or self.inflight is not None:
            while i < len(patterns) and self.submit(base + i, patterns[i]):
                i += 1
            if not self.pump() and i >= len(patterns):
                time.sleep(50e-6)  # only aging can unblock now
        return [self.results.pop(base + j) for j in range(len(patterns))]

    def stats(self) -> dict:
        lat = np.asarray(self.latency_s) if self.latency_s else np.zeros(1)
        return {
            "admitted": self.n_admitted,
            "rejected": self.n_rejected,
            "served": len(self.latency_s),
            "batches": self.n_batches,
            "rows_padded": self.n_rows_padded,
            "shapes": sorted(self.shapes),
            "lat_p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 3),
            "lat_p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 3),
            "cache": self.cache.stats(),
        }


def make_hot_workload(s: np.ndarray, rng: np.random.Generator, *,
                      n_requests: int, hot_pool: int = 32,
                      hot_frac: float = 0.8, min_len: int = 4,
                      max_len: int = 24, n_symbols: int = 4,
                      ) -> list[np.ndarray]:
    """A skewed request stream: ``hot_frac`` of the requests re-ask one of
    ``hot_pool`` planted patterns; the rest are fresh planted or random
    patterns (the same stream as the JAX package's from the same ``rng``)."""
    hot = []
    for _ in range(hot_pool):
        m = int(rng.integers(min_len, max_len + 1))
        i = int(rng.integers(0, len(s) - 1 - m))
        hot.append(np.asarray(s[i : i + m], np.int32))
    out = []
    for _ in range(n_requests):
        if rng.random() < hot_frac:
            out.append(hot[int(rng.integers(0, hot_pool))])
        else:
            m = int(rng.integers(min_len, max_len + 1))
            if rng.random() < 0.5:
                i = int(rng.integers(0, len(s) - 1 - m))
                out.append(np.asarray(s[i : i + m], np.int32))
            else:
                out.append(rng.integers(0, n_symbols, size=m,
                                        dtype=np.int32))
    return out


def run_closed_loop(dev: DeviceIndex, patterns, config: ServeConfig,
                    ) -> tuple[list[tuple], dict]:
    """Serve a whole workload closed-loop on a fresh server; returns
    ``(results, stats)`` with the wall seconds and qps added."""
    server = AsyncServer(dev, config)
    t0 = time.perf_counter()
    results = server.serve(patterns)
    wall = time.perf_counter() - t0
    stats = server.stats()
    stats["wall_s"] = round(wall, 4)
    stats["qps"] = round(len(patterns) / max(wall, 1e-9), 1)
    return results, stats


def serve_stream(dataset_name: str = "dna", *, n: int = 100_000,
                 requests: int = 4096, hot_frac: float = 0.8,
                 hot_pool: int = 32, min_len: int = 4, max_len: int = 24,
                 memory_bytes: int = 1 << 20, seed: int = 0,
                 index_path: str | None = None, mode: str = "all",
                 shards: int = 0, device="cuda") -> dict:
    """Build (or warm-start) an index on ``device``, run the serving stack
    on a hot workload, and report the stats of each mode: ``sync`` (no
    pipeline, no cache), ``async`` (pipeline), ``cached`` (pipeline and
    cache) or ``all``; ``vs_sync`` is a mode's qps over sync's when sync
    ran first."""
    if shards > 0:
        raise NotImplementedError(
            "sharded serving (shards > 0) is not ported yet (ROADMAP A12)")
    max_len4 = -(-max_len // 4) * 4

    def build(s, alphabet):
        cfg = EraConfig(memory_bytes=memory_bytes, build_impl="none")
        return EraIndexer(alphabet, cfg, device=device).build_device(
            s, max_pattern_len=max(64, max_len4))

    dev, s, alphabet, t_build = load_or_build(
        index_path, dataset_name, n, seed,
        load=lambda path: DeviceIndex.load(path, device=device), build=build)
    rng = np.random.default_rng(seed + 7)
    pats = make_hot_workload(s, rng, n_requests=requests, hot_pool=hot_pool,
                             hot_frac=hot_frac, min_len=min_len,
                             max_len=max_len,
                             n_symbols=len(alphabet.symbols))
    modes = {
        "sync": ServeConfig(pipeline=False, cache_size=0),
        "async": ServeConfig(pipeline=True, cache_size=0),
        "cached": ServeConfig(pipeline=True),
    }
    wanted = modes if mode == "all" else {mode: modes[mode]}
    report = {"dataset": dataset_name, "device": str(dev.device),
              "n_symbols": len(s), "requests": requests,
              "t_build_s": round(t_build, 3)}
    baseline = None
    for name, cfg in wanted.items():
        run_closed_loop(dev, pats, cfg)  # warm-up pass, then the timed one
        _, stats = run_closed_loop(dev, pats, cfg)
        if name == "sync":
            baseline = stats["qps"]
        if baseline:
            stats["vs_sync"] = round(stats["qps"] / baseline, 2)
        report[name] = stats
    return report


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="dna",
                    choices=["dna", "genome", "protein", "english", "byte"])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--requests", type=int, default=4096)
    ap.add_argument("--hot-frac", type=float, default=0.8)
    ap.add_argument("--hot-pool", type=int, default=32)
    ap.add_argument("--min-len", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=24)
    ap.add_argument("--mode", default="all",
                    choices=["all", "sync", "async", "cached"])
    ap.add_argument("--index-path", default=None,
                    help="npz cache: load the flattened index if the file "
                         "exists, else build once and save it there")
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand kernels) or cpu (plain PyTorch versions)")
    args = ap.parse_args()
    report = serve_stream(args.dataset, n=args.n, requests=args.requests,
                          hot_frac=args.hot_frac, hot_pool=args.hot_pool,
                          min_len=args.min_len, max_len=args.max_len,
                          index_path=args.index_path, mode=args.mode,
                          device=args.device)
    for key, val in report.items():
        print(f"{key}: {val}")


if __name__ == "__main__":
    main()

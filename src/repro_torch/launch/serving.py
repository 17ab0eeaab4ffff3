"""Async continuous-batching serving stack — PyTorch port of
``repro.launch.serving``.

:mod:`repro_torch.launch.query_serve` measures the engine: pre-padded
batches through ``find_batch_ranges``, one at a time, blocking on every
call.  This module is the tier users put in front of a
:class:`repro_torch.core.query.DeviceIndex` or a sharded index:

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

* **Sharded backend** — hand the server a
  :class:`repro_torch.core.fabric.ShardedIndex` and each batch splits by
  route key into per-shard sub-batches: each its own pow2 pad and pack,
  uploaded next to its shard's arrays, one search (or find-and-fetch)
  launch, its own copies back and its own event; patterns shorter than
  ``k_route`` take a row in every shard their route covers.  Each shard
  keeps its own route cache, looked up at the pattern's primary (lowest
  covered) shard.  Consuming a batch waits on its sub-batches' events,
  concatenates and sorts the positions, and takes the window from the
  first shard in route order with a hit, so results equal the
  single-index server's.  ``--shards`` turns it on.

* **Observability** — with ``REPRO_TRACE=1`` / ``REPRO_METRICS=1`` (or
  :func:`repro_torch.obs.configure` before the server is made) each batch
  records the JAX server's spans (``serve/queue_wait``, ``serve/pad_pack``,
  ``serve/device_dispatch`` — the dispatch carrying the ``link`` of its
  queue wait, and ``shard=k`` on a sharded index — and
  ``serve/consume_sync``), the ``serve/index_swap`` instant, and its
  ``serve_*`` counters, histograms and callback gauges, bound once at
  construction.  A span reads the host clock only, so a dispatch stays
  free of host syncs with the recorder on.  ``--metrics-port`` serves the
  live registry as Prometheus text (:func:`start_metrics_server`), and the
  driver writes the trace and metrics files at exit when enabled.

Every :class:`ServeConfig` field defaults from a ``REPRO_SERVE_*``
variable, with the JAX package's names and defaults; ``stats()`` reports
every counter the JAX server reports.

  PYTHONPATH=src python -m repro_torch.launch.serving --dataset dna \\
      --n 100000 --requests 4096 --mode all        # --device cpu: plain path
"""

from __future__ import annotations

import argparse
import collections
import os
import threading
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.api import EraConfig, EraIndexer
from repro_torch.core.fabric import ShardedIndex
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
    resolved at admission, and the host tensors its results land in.

    Single index: ``row_of`` holds each request's batch row (None = cache
    hit) and ``out`` the (start, count[, window]) host tensors.  Sharded:
    ``row_of`` holds each request's ``[(shard, local row), ...]`` and
    ``out`` maps each shard to its sub-batch's host tensors.
    ``ready`` holds the CUDA events recorded after the copies (one per
    sub-batch; none on the CPU)."""

    __slots__ = ("requests", "keys", "row_of", "hit_vals", "n_rows", "out",
                 "ready")

    def __init__(self, requests, keys, row_of, hit_vals, n_rows):
        self.requests = requests
        self.keys = keys
        self.row_of = row_of
        self.hit_vals = hit_vals
        self.n_rows = n_rows      # real rows before the b_pad padding
        self.out = ()
        self.ready: list = []

    def wait(self) -> None:
        """Block until this batch's results are on the host (its own
        events only)."""
        for ev in self.ready:
            ev.synchronize()


def _frozen(*arrays) -> tuple:
    """The arrays made read-only: one result may serve many requests."""
    for a in arrays:
        if a is not None:
            a.flags.writeable = False
    return arrays


class AsyncServer:
    """Continuous-batching server over a :class:`DeviceIndex` or a
    :class:`ShardedIndex`.

    A single-threaded loop: :meth:`submit` admits requests; :meth:`pump`
    (or :meth:`serve`) coalesces a batch, dispatches it without blocking and
    consumes the previous batch while the new one runs.  Each request's
    result is ``(positions, window)``: its sorted int64 occurrence
    positions and, when ``config.fetch`` > 0, the (fetch,) int32 text at
    its first suffix-array-order match (else None), both read-only.
    """

    def __init__(self, dev, config: ServeConfig | None = None):
        self.dev = dev
        self.config = config or ServeConfig()
        self.sharded = isinstance(dev, ShardedIndex)
        n_caches = dev.n_shards if self.sharded else 1
        self.caches = [RouteCache(self.config.cache_size)
                       for _ in range(n_caches)]
        self.cache = self.caches[0]
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
        # span links: each taken batch gets a fresh link id, stamped on its
        # serve/queue_wait span and on the serve/device_dispatch span(s) it
        # becomes, so a trace viewer joins the wait to the work it fed
        self._link_seq = 0
        self._cur_link = 0
        self._width_cap = max(4, dev.max_pattern_len - dev.max_pattern_len % 4)
        self._bind_obs()

    def _bind_obs(self) -> None:
        """Bind the tracer and the registry's instruments once, at
        construction (``repro.launch.serving.AsyncServer._bind_obs``): a
        batch then pays an attribute access and, with the recorder off, a
        no-op call."""
        tr, m = obs.tracer(), obs.metrics()
        self._tr = tr
        self._trace_on = tr.enabled
        self._metrics_on = m.enabled
        self._m_requests = m.counter(
            "serve_requests_total", "requests admitted")
        self._m_rejected = m.counter(
            "serve_rejected_total", "requests rejected at admission")
        self._m_batches = m.counter(
            "serve_batches_total", "padded batches dispatched")
        self._m_rows_real = m.counter(
            "serve_rows_real_total", "real (non-padding) batch rows")
        self._m_rows_padded = m.counter(
            "serve_rows_padded_total", "batch rows incl. pow2 padding")
        self._m_cache_hits = m.counter(
            "serve_cache_hits_total", "route-cache hits at admission")
        self._m_cache_misses = m.counter(
            "serve_cache_misses_total", "route-cache misses at admission")
        self._m_index_swaps = m.counter(
            "serve_index_swaps_total", "live index generation swaps")
        self._m_cache_flushes = m.counter(
            "serve_cache_flushes_total",
            "route-cache flushes forced by an index epoch change")
        self._h_queue_depth = m.histogram(
            "serve_queue_depth",
            buckets=obs.pow2_buckets(1, self.config.queue_depth),
            help="admission-queue depth sampled at each pump")
        self._h_batch_fill = m.histogram(
            "serve_batch_fill", buckets=(0.1, 0.25, 0.5, 0.75, 0.9, 1.0),
            help="real rows / padded rows per dispatched batch")
        self._h_queue_wait = m.histogram(
            "serve_queue_wait_ms",
            help="per-request wait from admission to batch dispatch")
        self._h_batch_age = m.histogram(
            "serve_batch_age_ms",
            help="oldest queued request's age at dispatch (the "
                 "max_wait_ms batch-aging signal)")
        # callback gauges read the live server when a snapshot is taken;
        # on re-registration the newest server's callbacks win
        m.gauge("serve_cache_size",
                fn=lambda: sum(len(c) for c in self.caches),
                help="route-cache entries (all shards)")
        m.gauge("serve_cache_hit_rate", fn=lambda: self._cache_hit_rate(),
                help="route-cache lifetime hit rate (all shards)")
        m.gauge("serve_queue_depth_now", fn=lambda: len(self.queue),
                help="admission-queue depth right now")

    # ---- admission --------------------------------------------------------

    def submit(self, rid, pattern, now: float | None = None) -> bool:
        """Admit one request; False (and a count) when the queue is full."""
        if len(self.queue) >= self.config.queue_depth:
            self.n_rejected += 1
            self._m_rejected.inc()
            return False
        self.queue.append(_Request(rid, pattern,
                                   time.perf_counter() if now is None else now))
        self.n_admitted += 1
        self._m_requests.inc()
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

    def _cache_hit_rate(self) -> float:
        hits = sum(c.hits for c in self.caches)
        total = hits + sum(c.misses for c in self.caches)
        return hits / total if total else 0.0

    def _cache_stats(self) -> dict:
        if not self.sharded:
            return self.cache.stats()
        agg = {"size": sum(len(c) for c in self.caches),
               "capacity": sum(c.capacity for c in self.caches),
               "hits": sum(c.hits for c in self.caches),
               "misses": sum(c.misses for c in self.caches),
               "evictions": sum(c.evictions for c in self.caches),
               "hit_rate": self._cache_hit_rate()}
        agg["per_shard"] = [c.stats() for c in self.caches]
        return agg

    def _take_batch(self) -> list[_Request] | None:
        """Pop up to ``max_batch`` requests; a partial batch is held open
        (None) until its oldest request has waited ``max_wait_ms``."""
        if not self.queue:
            return None
        cfg = self.config
        now = time.perf_counter()
        oldest_age_ms = (now - self.queue[0].t_admit) * 1e3
        if len(self.queue) < cfg.max_batch and oldest_age_ms < cfg.max_wait_ms:
            return None
        requests = [self.queue.popleft()
                    for _ in range(min(len(self.queue), cfg.max_batch))]
        self._link_seq += 1
        self._cur_link = self._link_seq
        if self._metrics_on:
            self._h_batch_age.observe(oldest_age_ms)
            for r in requests:
                self._h_queue_wait.observe((now - r.t_admit) * 1e3)
        if self._trace_on:
            self._tr.complete("serve/queue_wait",
                              int(requests[0].t_admit * 1e9),
                              int(oldest_age_ms * 1e6),
                              rows=len(requests), link=self._cur_link)
        return requests

    @staticmethod
    def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
        """A host batch array on ``device``: pinned, then copied without
        blocking the host."""
        t = torch.from_numpy(a)
        if device.type != "cuda":
            return t
        return t.pin_memory().to(device, non_blocking=True)

    @staticmethod
    def _download(flight: _InFlight, outs, n_rows: int,
                  device: torch.device) -> tuple:
        """Start the copies of one (sub-)batch's results to the host: fresh
        pinned tensors (never reused while a copy may be in flight), then
        one event on ``device``'s stream for the consume to wait on.
        Returns the host tensors."""
        if device.type != "cuda":
            return tuple(t[:n_rows] for t in outs)
        host = []
        for t in outs:
            h = torch.empty(t[:n_rows].shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t[:n_rows], non_blocking=True)
            host.append(h)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(device))
        flight.ready.append(ready)
        return tuple(host)

    def _launch(self, dev: DeviceIndex, flight: _InFlight, reqs,
                shard: int | None = None) -> tuple:
        """Pad, pack and upload one (sub-)batch next to ``dev``'s arrays,
        launch its search (or find-and-fetch) and start the copies back;
        returns the host tensors.  ``shard`` (a sharded index's sub-batch)
        goes on the spans."""
        cfg = self.config
        at = {} if shard is None else {"shard": shard}
        n = len(reqs)
        pats = [r.pattern for r in reqs]
        m_pad = self._bucket_width(-(-max(len(p) for p in pats) // 4) * 4)
        b_pad = self._bucket_rows(n)
        with self._tr.span("serve/pad_pack", **at, rows=n, b_pad=b_pad,
                           m_pad=m_pad):
            padded, lengths, route = dev.pad_batch(pats, m_pad=m_pad,
                                                   b_pad=b_pad)
            self.shapes.add((m_pad, b_pad))
            self.n_rows_padded += b_pad
            padded, lengths, route = (self._upload(a, dev.device)
                                      for a in (padded, lengths, route))
        self._m_rows_real.inc(n)
        self._m_rows_padded.inc(b_pad)
        self._h_batch_fill.observe(n / b_pad)
        pat_max = max(r.pat_max for r in reqs)
        with self._tr.span("serve/device_dispatch", **at, rows=n,
                           b_pad=b_pad, m_pad=m_pad, fetch=cfg.fetch,
                           link=self._cur_link):
            if cfg.fetch:
                outs = dev.find_fetch_ranges(padded, lengths, route,
                                             fetch=cfg.fetch,
                                             pat_max=pat_max)[:3]
            else:
                outs = dev.find_batch_ranges(padded, lengths, route,
                                             pat_max=pat_max)
            return self._download(flight, outs, n, dev.device)

    def _dispatch(self) -> _InFlight | None:
        """Coalesce up to ``max_batch`` queued requests into one padded
        batch and dispatch it without blocking.  Cache hits resolve here
        (no batch row); with the cache on, a pattern repeated in the batch
        shares one row."""
        requests = self._take_batch()
        if requests is None:
            return None
        if self.sharded:
            return self._dispatch_sharded(requests)
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
                    self._m_cache_hits.inc()
                    hit_vals[key] = val
                    row_of.append(None)
                    continue
                self._m_cache_misses.inc()
                key_row[key] = len(miss_req)
            row_of.append(len(miss_req))
            miss_req.append(req)

        flight = _InFlight(requests, keys, row_of, hit_vals, len(miss_req))
        if miss_req:
            flight.out = self._launch(self.dev, flight, miss_req)
        self.n_batches += 1
        self._m_batches.inc()
        return flight

    def _dispatch_sharded(self, requests: list[_Request]) -> _InFlight:
        """The ShardedIndex backend: split the batch by route key, then pad,
        pack and dispatch one pow2-bucketed sub-batch PER SHARD, next to
        that shard's arrays, without blocking.  Patterns shorter than
        ``k_route`` may span shards: they take one row in every covered
        shard and merge at consume time.  Cache lookups go to the primary
        (lowest covered) shard's cache: route→shard is deterministic, so
        the per-shard caches partition the key space."""
        cfg = self.config
        keys = [self.dev.route_key(r.pattern) for r in requests]
        caching = cfg.cache_size > 0
        # per request: None = cache hit, else [(shard, local row), ...]
        row_of: list[list | None] = []
        key_rows: dict[tuple, list] = {}
        hit_vals: dict[tuple, tuple] = {}
        shard_req: dict[int, list[_Request]] = {}
        for req, key in zip(requests, keys):
            if caching:
                if key in hit_vals:
                    row_of.append(None)
                    continue
                if key in key_rows:  # in-batch duplicate: share the rows
                    row_of.append(key_rows[key])
                    continue
            lo, hi = self.dev.shard_span(req.pattern)
            if caching:
                val = self.caches[lo].get(key)
                if val is not None:
                    self._m_cache_hits.inc()
                    hit_vals[key] = val
                    row_of.append(None)
                    continue
                self._m_cache_misses.inc()
            rows = []
            for k in range(lo, hi + 1):
                local = shard_req.setdefault(k, [])
                rows.append((k, len(local)))
                local.append(req)
            if caching:
                key_rows[key] = rows
            row_of.append(rows)

        flight = _InFlight(requests, keys, row_of, hit_vals,
                           sum(len(r) for r in shard_req.values()))
        flight.out = {k: self._launch(self.dev.shards[k], flight, reqs,
                                      shard=k)
                      for k, reqs in sorted(shard_req.items())}
        self.n_batches += 1
        self._m_batches.inc()
        return flight

    def _consume(self, flight: _InFlight) -> None:
        """Wait for one batch's results (its own event only) and hand them
        to its requests; misses fill the cache with the materialized result.
        Rows with the same bounds share one materialized result (a hot
        pattern repeated in a batch without the cache is sorted once), so
        results are read-only arrays."""
        if self.sharded:
            return self._consume_sharded(flight)
        cfg = self.config
        if flight.n_rows:
            with self._tr.span("serve/consume_sync", rows=flight.n_rows):
                flight.wait()
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

    def _consume_sharded(self, flight: _InFlight) -> None:
        """Wait for every sub-batch of one batch (its own events) and merge
        per request: positions concatenate and sort (shards own disjoint
        leaf ranges); the window comes from the first shard in route order
        with a hit — the rule of :meth:`ShardedIndex.find_fetch_batch`.
        Misses fill their primary shard's cache."""
        cfg = self.config
        mats = {}
        for i, (k, host) in enumerate(sorted(flight.out.items())):
            with self._tr.span("serve/consume_sync", shard=k,
                               rows=host[0].shape[0]):
                if flight.ready:  # one event per sub-batch on the card
                    flight.ready[i].synchronize()
                mats[k] = tuple(t.numpy() for t in host)
        done: dict[tuple, tuple] = {}
        caching = cfg.cache_size > 0
        now = time.perf_counter()
        for req, key, rows in zip(flight.requests, flight.keys,
                                  flight.row_of):
            if rows is None:
                val = flight.hit_vals[key]
            elif tuple(rows) in done:
                val = done[tuple(rows)]
            else:
                parts, win_out = [], None
                for k, row in rows:
                    start, count = mats[k][0], mats[k][1]
                    s, c = int(start[row]), int(count[row])
                    if c:
                        ell = self.dev.shards[k].ell_host
                        parts.append(ell[s:s + c].astype(np.int64))
                        if cfg.fetch and win_out is None:
                            win_out = mats[k][2][row].copy()
                if cfg.fetch and win_out is None:
                    win_out = np.full(cfg.fetch, -1, np.int32)
                pos = (np.sort(np.concatenate(parts)) if parts
                       else np.empty(0, np.int64))
                val = _frozen(pos, win_out if cfg.fetch else None)
                done[tuple(rows)] = val
                if caching:
                    self.caches[rows[0][0]].put(key, val)
            self.results[req.rid] = val
            self.latency_s.append(now - req.t_admit)

    # ---- live index swap --------------------------------------------------

    def update_index(self, dev) -> dict:
        """Swap in a new index generation (a :class:`DeviceIndex` or a
        :class:`ShardedIndex`) without dropping queued requests: the
        in-flight batch (dispatched against the old index) is consumed
        first.  The route caches are rebuilt when the shard count changes,
        flushed when the ``epoch`` changes and kept on a same-epoch swap
        (a replica of the same index)."""
        if self.inflight is not None:
            self._consume(self.inflight)
            self.inflight = None
        old_epoch = int(getattr(self.dev, "epoch", 0))
        new_epoch = int(getattr(dev, "epoch", 0))
        self.dev = dev
        self.sharded = isinstance(dev, ShardedIndex)
        n_caches = dev.n_shards if self.sharded else 1
        flushed = False
        if len(self.caches) != n_caches:
            self.caches = [RouteCache(self.config.cache_size)
                           for _ in range(n_caches)]
            flushed = True
        elif new_epoch != old_epoch:
            for c in self.caches:
                c.clear()
            flushed = True
        self.cache = self.caches[0]
        self._width_cap = max(4, dev.max_pattern_len - dev.max_pattern_len % 4)
        self.n_index_swaps += 1
        self._m_index_swaps.inc()
        if flushed:
            self._m_cache_flushes.inc()
        if self._trace_on:
            self._tr.instant("serve/index_swap", epoch=new_epoch,
                             flushed=int(flushed), shards=n_caches)
        return {"epoch": new_epoch, "flushed": flushed, "shards": n_caches}

    # ---- the serving loop -------------------------------------------------

    def pump(self) -> bool:
        """One loop turn: dispatch the next batch, then consume the previous
        one.  False means the loop is idle (empty, or holding a partial
        batch open for aging)."""
        if self.queue:
            self._h_queue_depth.observe(len(self.queue))
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
            "cache": self._cache_stats(),
        }


def start_metrics_server(port: int, host: str = "127.0.0.1"):
    """A pull-based metrics endpoint on a standard-library ``http.server``
    daemon thread (``repro.launch.serving.start_metrics_server``): GET
    ``/`` or ``/metrics`` returns the live registry as Prometheus text
    (the payload ``obs.export_all`` writes to ``era_metrics.prom``), any
    other path 404.  ``port=0`` binds a free port
    (``server.server_address[1]``).  Returns the server; ``shutdown()``
    stops it."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.split("?", 1)[0].rstrip("/") not in ("", "/metrics"):
                self.send_error(404)
                return
            body = obs.metrics().to_prometheus().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # keep the serving loop's stdout clean
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(target=server.serve_forever,
                              name="era-metrics", daemon=True)
    thread.start()
    return server


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


def run_closed_loop(dev, patterns, config: ServeConfig,
                    ) -> tuple[list[tuple], dict]:
    """Serve a whole workload closed-loop on a fresh server over ``dev``
    (a DeviceIndex or a ShardedIndex); returns ``(results, stats)`` with
    the wall seconds and qps added."""
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
    ran first.  ``shards`` > 0 serves a :class:`ShardedIndex` of that many
    route-key shards (built over every device of ``device``'s type, cached
    as per-shard archives); 0 the single DeviceIndex."""
    max_len4 = -(-max_len // 4) * 4
    mpl = max(64, max_len4)

    def build(s, alphabet):
        cfg = EraConfig(memory_bytes=memory_bytes, build_impl="none")
        ix = EraIndexer(alphabet, cfg, device=device)
        if shards > 0:
            return ix.build_sharded(s, n_shards=shards, max_pattern_len=mpl)
        return ix.build_device(s, max_pattern_len=mpl)

    loader = ShardedIndex.load if shards > 0 else DeviceIndex.load
    dev, s, alphabet, t_build = load_or_build(
        index_path, dataset_name, n, seed,
        load=lambda path: loader(path, device=device), build=build,
        sharded=shards > 0)
    where = (sorted({str(d) for d in dev.devices}) if shards > 0
             else [str(dev.device)])
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
    report = {"dataset": dataset_name, "device": ",".join(where),
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
                         "exists, else build once and save it there "
                         "(per-shard _shard{k}.npz archives with --shards)")
    ap.add_argument("--shards", type=int, default=0,
                    help="serve a ShardedIndex with this many route-key "
                         "shards (0 = single DeviceIndex)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand kernels) or cpu (plain PyTorch versions)")
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="expose the live metrics registry as a Prometheus "
                         "text endpoint on this port (0 = off)")
    args = ap.parse_args()
    metrics_srv = None
    if args.metrics_port:
        metrics_srv = start_metrics_server(args.metrics_port)
        print(f"metrics: http://127.0.0.1:"
              f"{metrics_srv.server_address[1]}/metrics")
    report = serve_stream(args.dataset, n=args.n, requests=args.requests,
                          hot_frac=args.hot_frac, hot_pool=args.hot_pool,
                          min_len=args.min_len, max_len=args.max_len,
                          index_path=args.index_path, mode=args.mode,
                          shards=args.shards, device=args.device)
    for key, val in report.items():
        print(f"{key}: {val}")
    for path in obs.export_all():
        print(f"wrote {path}")
    if metrics_srv is not None:
        metrics_srv.shutdown()


if __name__ == "__main__":
    main()

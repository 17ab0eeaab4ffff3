#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port's ported paths.

Drives ``repro_torch`` on one CUDA card, through the entry points a user
calls, at chromosome scale (n = 2**27 symbols by default) on two paths:

* the DNA path — the ``genome`` dataset, dense 2-bit words
  (``range_gather_words``, ``kmer_histogram``, and ``search_bounds_words``:
  each search batch one launch), plus a batch carrying the terminal code
  (a loop of ``pattern_probe_packed`` steps);
* the protein path — the ``protein`` dataset, byte-per-symbol text, the
  byte-key currency (``range_gather_pack``, ``lcp_pairs``,
  ``search_bounds_bytes``, and ``kmer_histogram`` for the partition);
* the tree + analytics path on both datasets —
  ``EraIndexer(alphabet, EraConfig(node_lcp="words")).build(s)`` →
  ``SuffixTreeIndex`` → ``index.analytics()`` → the ``analytics_serve``
  loop (``suffix_lcp_words`` on DNA, ``suffix_lcp_pairs`` on protein, the
  node build's divergence rows and the global LCP's boundaries; matching
  statistics lower-bound through ``search_bounds_words`` /
  ``search_bounds_bytes``, one launch a batch);
* the ``REPRO_WORD_COMPARE=byte`` oracle leg on ``genome`` at n = 2**25
  (``range_gather_packed``, and ``probe_gather_packed`` for find-and-fetch),
  held equal to the word leg;
* find-and-fetch serving on both indexes — ``DeviceIndex.find_fetch_batch``
  (one ``search_fetch_words`` launch a batch on DNA, one
  ``search_fetch_bytes`` launch on the protein byte text, the loop of
  ``pattern_probe_packed`` steps and ``probe_gather_packed`` for the DNA
  terminal-bearing batch) and the ``AsyncServer`` stack through
  ``run_closed_loop`` in its sync, async and cached modes;
* LM serving — ``repro_torch.launch.serve.serve("qwen3-1.7b",
  smoke=False)``: all 28 layers at full width (d_model 2048, 16 query and
  8 KV heads of width 128, vocab 151,936; random weights from a seed) in
  bf16, prefilling 4 prompts of 2048 tokens through the hand-written
  ``flash_attention`` kernel (its bf16 design, ``wgmma_tma``: tensor-core
  tiles fed by TMA), then decoding 32 tokens greedily.

Phases, each printing one JSON line:

1. device   — the card (``nvidia-smi`` name and power limit), torch/CUDA
              versions, and the build of every CUDA kernel from ``csrc/``;
   dram_round_trip — one dependent device-memory round trip
              (``csrc/dram_latency.cu``), the unit of the search kernels'
              latency bounds;
2. parity   — each hand kernel against its plain PyTorch version on the
              card, exact equality (integer kernels), with its time (the
              search kernels at the 2^27 indexes, after their paths: each
              against the loop with the plain probes, the loop of
              single-step kernels and a counted loop, on the serving
              batch, unrouted and empty windows, terminal-tail patterns,
              the lower bound alone, NW at and past the register
              templates, B = 1, B = 0 and 2^20 rows; the fused
              find-and-fetch kernels against their plain version and the
              search + epilogue kernels they fuse, all four outputs, on
              the find-and-fetch batch, end-of-text windows, empty
              windows, fetch 4 and 64, NW past the templates, B = 1, 33
              and 0 and 2^20 lanes; the three elastic-range
              gathers also on every NW template and two nw outside them,
              0, 1, 4099 and 2^22 + 5 rows, offsets at the text's end
              (past n_real for ``range_gather_packed``), without a mask,
              with a mixed one and with every row off, on the 2-, 4- and
              8-bit dense texts and the protein and byte strings, and in
              one launch of more than 2^31 output words;
              ``kmer_histogram`` at every k the partition counts with it on
              the genome and protein strings and the BYTE string (k = 2:
              2^16 bins, the cluster layout), each with a start off every
              16-byte boundary, one window, ragged tails, a homopolymer
              and a planted motif, beside ``torch.bincount`` of the codes;
              ``suffix_lcp_words`` at bits 2, 4 and 8 on neighbour pairs
              chained as adjacent leaves, partly chained and unchained,
              with pairs at the text's end, at w = 4 … 256 and every NW
              bucket the padding allows);
3. build    — ``EraIndexer(alphabet, EraConfig()).build_device(s)``;
   build_profile — one more warm build per dataset under
              ``torch.profiler`` (and one of the byte leg, phase 7):
              device ms and calls of every kernel of the build, each port
              kernel's ms beside its bound for the counted build's rows,
              the gathers' ms and share of ``t_prepare_s``, the device's
              busy share of the build;
4. check    — ``ell`` is a permutation of the suffixes, and ``find_batch``
              equals a brute-force occurrence scan on the device (for DNA
              also on a batch of patterns ending in the terminal code);
5. serving  — the ``query_serve`` loop (batch 256, lengths 4–24);
   search_launches — one search batch per counted DNA, protein and tree
              path, counted from 0: its search kernel launched once and no
              single-step probe, or the run fails;
   find_fetch — ``find_fetch_batch`` (fetch 32) on 256 planted and random
              patterns: ranges equal ``find_batch`` and the scan, windows
              equal the text read on the card, ``verified`` 0 where found,
              the find-and-fetch calls counted alone (one fused launch a
              batch); then its batch latency beside the search alone and
              beside the search + epilogue kernels it fuses
              (``find_fetch_ranges_unfused_ms``, equal outputs);
   serving_stack — ``run_closed_loop`` in sync, async and cached mode with
              fetch 0 and 32 on a hot workload of 16,384 requests, each mode
              warmed once with every ``_dispatch`` under
              ``torch.cuda.set_sync_debug_mode("error")`` and launching
              exactly one kernel (the search, or the fused find-and-fetch)
              when it has rows, every result equal to ``find_batch`` /
              ``find_fetch_batch``;
6. tree / analytics / analytics_serving — the tree path per dataset:
              build, engine, the serving loop (batch 512, window 64, 20
              batches), then its checks against brute force on the card;
   tree_layers — the node build's layers timed alone, with CUDA events
              around each launch of the text-LCP kernel in
              ``boff_rows_from_text``: per ``lcp_from_text`` round its w,
              pending rows, adjacency share and device ms, the kernel's
              total beside ``t_rows_and_text_lcp_s`` (the rest is glue);
7. byte_leg — build_device, find_batch and the analytics LCP array under
              ``REPRO_WORD_COMPARE=byte``, equal to the word leg; then a
              profiled warm byte-leg build (``build_profile``,
              ``range_gather_packed`` and ``lcp_pairs`` in the build);
8. LM       — ``parity`` of ``flash_attention`` against its plain version
              (float32 rtol 1e-5 / atol 2e-5 with TF32 off, the
              ``cuda_cores`` design; bf16 one bf16 ulp of the output, rtol
              2^-7 / atol 2e-5, the ``wgmma_tma`` design), on the JAX
              test's shapes, Sq != Sk, ragged lengths, D 16 to 256, GQA
              groups 1 to 8, q x 8 and the prefill shape; each case's
              design is checked; ``lm_serving``: ``serve`` three times
              (cold, warm, under ``torch.profiler``) with 28 kernel
              launches in each prefill and none in the decode, tokens in
              the vocabulary, the cache at 2048 + 31; ``lm_check``: in
              float32, decode steps 1 and 8 (``_sdpa`` over the cache)
              against fresh prefills (the kernel) within ``LM_TOL`` of the
              largest logit, and a 2-layer prefill on the card against the
              CPU's plain versions within ``CPU_TOL``;
9. kernels  — each kernel at the main path's shapes: time, plain-version
              time, bound, and its launches on the paths above
              (``flash_attention``: the warm ``lm_serving`` run; the fused
              kernels also at 2^20 rows, beside the time of the two ported
              kernels they fuse; the fused find-and-fetch kernels beside
              ``unfused_ms`` (the search and epilogue kernels they replace)
              and a latency bound (the longest lane's dependent round trips
              times the measured one), at batch 256 and 2^20 lanes;
              the search kernels beside ``loop_ms``, the
              loop of single-step kernels they replace, with this run's
              trips per row against ``n_iter``; ``flash_attention`` beside
              SDPA's time as ``library_ms``, with its bf16 ``design``;
              the two elastic-range gathers with the rows and words their
              counted launches gathered, the excess weighted by those
              rows, their ms in the profiled builds, the gather on sorted
              positions (beside the sort for ``range_gather_pack``), and
              under a persisting L2 window, which no kernel sets: it
              measured slower); every kernel a build launches with its ms
              in the profiled builds; ``kmer_histogram`` with its layout
              and ms at every counted k beside ``bincount_ms``;
              ``suffix_lcp_words`` with the adjacency share of its
              main-path pairs, its w = 256 times and its ms in the tree;
              ``range_gather_packed`` and ``suffix_lcp_pairs`` beside
              their earlier designs (``baseline_ms``, the sources in
              ``src/repro_torch/kernels/baseline``, built beside the port's
              and timed in turns on the same inputs, outputs held equal).

Launch counts are set to 0 just before each path (build + check +
serving, the terminal-bearing check, the find-and-fetch calls of each
find_fetch phase, the fetch 0 and the fetch 32 passes of each
serving_stack phase, each tree path from build to the end of its serving loop, each leg
of the byte-leg phase, each LM serving run and the LM check) and read
just after; the phase lines carry the counts so far.  Every kernel of a
path must have launched in it.  Any failure raises and exits
non-zero.  The last line is ``{"ok": true, "device": {...}}``.  Without a
CUDA card, or without the rest of the repository, the script exits
non-zero and prints no result.

  python3 chip_smoke.py                # n = 2**27 (the default)
  python3 chip_smoke.py --n-log2 20    # a short run (the LM phases keep
                                       # their full size)
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
OPS_PER_S = 67e12           # H100 SXM 32-bit non-tensor peak (data sheet)
DNA_KERNELS = ("range_gather_words", "search_bounds_words", "kmer_histogram")
TERMINAL_KERNELS = ("pattern_probe_packed",)
PROTEIN_KERNELS = ("kmer_histogram", "range_gather_pack", "lcp_pairs",
                   "search_bounds_bytes")
TREE_KERNELS = {
    "genome": ("kmer_histogram", "range_gather_words", "suffix_lcp_words",
               "search_bounds_words"),
    "protein": ("kmer_histogram", "range_gather_pack", "lcp_pairs",
                "suffix_lcp_pairs", "search_bounds_bytes"),
}
# the single-step probes a search no longer launches (the terminal-bearing
# batch and the byte leg keep their loop of pattern_probe_packed steps)
SEARCH_STEPS = {"search_bounds_words": "pattern_probe_words",
                "search_bounds_bytes": "pattern_probe"}
BYTE_LEG_KERNELS = ("range_gather_packed", "lcp_pairs", "pattern_probe_packed",
                    "probe_gather_packed")
WORD_ONLY_KERNELS = ("range_gather_words", "pattern_probe_words",
                     "suffix_lcp_words", "probe_gather_words",
                     "search_bounds_words")
# a word or byte-string find-and-fetch batch is one fused launch; a
# terminal-bearing batch keeps the loop and probe_gather_packed
FETCH_KERNELS = {
    "genome": ("search_fetch_words",),
    "terminal": ("pattern_probe_packed", "probe_gather_packed"),
    "protein": ("search_fetch_bytes",),
}
SEARCH_KERNELS = {"genome": "search_bounds_words",
                  "protein": "search_bounds_bytes"}
# the search and epilogue kernels the fused ones replace
UNFUSED = ("search_bounds_words", "search_bounds_bytes", "probe_gather_words",
           "pattern_probe", "range_gather_pack")
FETCH_ABSENT = {  # kernels a find-and-fetch path must not launch
    "genome": ("probe_gather_packed", "pattern_probe_words",
               "search_fetch_bytes") + UNFUSED,
    "terminal": ("probe_gather_words", "search_bounds_words",
                 "search_fetch_words", "search_fetch_bytes"),
    "protein": ("probe_gather_packed", "pattern_probe_words",
                "search_fetch_words") + UNFUSED,
}
# the kernels a build_device launches, per dataset (build_profile's rows;
# byte_leg: the genome build under REPRO_WORD_COMPARE=byte)
BUILD_KERNELS = {"genome": ("kmer_histogram", "range_gather_words"),
                 "protein": ("kmer_histogram", "range_gather_pack",
                             "lcp_pairs"),
                 "byte_leg": ("kmer_histogram", "range_gather_packed",
                              "lcp_pairs")}
GATHERS = ("range_gather_words", "range_gather_pack", "range_gather_packed")
# the earlier designs of the kernels this slice redesigned, timed beside
# them in turns (the port never calls them): source directory and design
YARDSTICK_DIR = ROOT / "src" / "repro_torch" / "kernels" / "baseline"
DESIGNS = {"range_gather_packed": ("row_read", "thread_per_key_word"),
           "suffix_lcp_pairs": ("chunked_shared_suffix",
                                "thread_per_pair_word_loop")}
# the gathers' edge cases: every NW template, two nw outside them, and
# launches of 0, 1, 4099 and 2^22 + 5 rows (ragged against rows a thread)
GATHER_NW = (1, 2, 3, 4, 5, 8, 16, 32, 64)
GATHER_ROWS = (0, 1, 4099, (1 << 22) + 5)
BYTE_LEG_LOG2 = 25  # the oracle leg's n: an oracle, not a user path
FETCH = 32          # symbols fetched per match on the find-and-fetch paths
SERVE_REQUESTS = 1 << 14
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak (data sheet)
# Decode against prefill in float32 over 28 layers, as a share of the
# largest logit: the decode's _sdpa and one-row products sum in another
# order than the prefill's kernel and 513-row products (measured 6.4e-7).
LM_TOL = 1e-5
# Card against CPU, float32, 2 layers: rtol and atol as a share of the
# largest logit, those of tests/test_torch_models.py (measured 1.2e-7).
CPU_TOL = (1e-4, 2e-5)
# flash_attention in bfloat16: one bf16 ulp of each output (ulp(x) <=
# 2^-7 |x|; kernel and plain version round one float32 result each), plus
# the float32 atol for outputs near 0 (measured 1.95e-3 = 2^-9, one ulp
# of an output in [0.25, 0.5), at the prefill shape).
BF16_TOL = (2.0 ** -7, 2e-5)
LM_ARCH = "qwen3-1.7b"  # the LM phases' model, at full width and depth


T_START = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:  # seconds since the start, for the time budget
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5, inner: int = 1) -> float:
    """Median milliseconds per call over ``reps`` CUDA-event windows of
    ``inner`` back-to-back calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least milliseconds, "bytes" | "operations") for the given work."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gather_work(f: int, nw: int, n_words: int) -> tuple[float, float]:
    """Bytes (offsets + text words touched + output) and 32-bit ops."""
    return (f * 4 + min(n_words, f * (nw + 1)) * 4 + f * nw * 4,
            f * nw * 20)


def probe_work(b: int, nw: int, n_words: int) -> tuple[float, float]:
    """Bytes (pos, pattern and mask rows, lengths, text words, verdict)."""
    return (b * 4 + 2 * b * nw * 4 + b * 4 + min(n_words, b * (nw + 1)) * 4
            + b * 4, b * nw * 30)


def kmer_work(n: int, k: int, base: int) -> tuple[float, float]:
    return (n + k - 1 + base**k * 4, n * (2 * k + 2))


def gather_pack_work(f: int, nw: int, n_s: int) -> tuple[float, float]:
    """Bytes (offsets + text bytes touched + output) and 32-bit ops of a
    byte-key gather: the text is read at most once."""
    return f * 4 + min(n_s, f * (4 * nw + 4)) + f * nw * 4, f * nw * 12


def lcp_work(f: int, nw: int) -> tuple[float, float]:
    """Bytes (both rows, three outputs) and ops, every word compared."""
    return 2 * f * nw * 4 + 3 * f * 4, f * nw * 4 + f * 8


def probe_bytes_work(b: int, nw: int, text_bytes: int) -> tuple[float, float]:
    """Bytes (pos, pattern and mask rows, text touched, verdict) and ops of
    a byte-key probe; ``text_bytes`` is the text it can touch."""
    return (b * 4 + 2 * b * nw * 4 + min(text_bytes, b * (4 * nw + 4))
            + b * 4, b * nw * 16)


def gather_packed_work(f: int, nw: int, bits: int,
                       n_words: int) -> tuple[float, float]:
    """Bytes (offsets, dense text words touched, key words out) and ops of
    a byte-key read from dense text: each dense word spreads to key words."""
    dense = -(-4 * nw * bits // 32) + 1
    return f * 4 + min(n_words, f * dense) * 4 + f * nw * 4, f * nw * 24


def suffix_lcp_work(lcp: torch.Tensor, w: int, syms_per_read: int,
                    text_bytes: int, read_bytes: int) -> tuple[float, float]:
    """Bytes and ops a suffix-pair LCP needs on this run's data: both
    positions in, one LCP out, and per suffix the reads up to its first
    difference (``syms_per_read`` symbols of ``read_bytes`` each)."""
    b = lcp.numel()
    reads = torch.clamp(lcp.to(torch.int64) // syms_per_read + 1,
                        max=-(-w // syms_per_read))
    total = int(reads.sum())
    return b * 12 + min(text_bytes, 2 * total * read_bytes), total * 2 * 16


def fused_work(b: int, nw_pat: int, nw_out: int, text_words: int,
               n_words: int, n_int_in: int) -> tuple[float, float]:
    """Bytes and ops of a fused probe + gather: ``n_int_in`` int32 inputs
    per row (positions, lengths), the pattern and mask rows, the text words
    this run's rows need, the verdict and the window out."""
    return (b * 4 * n_int_in + 2 * b * nw_pat * 4
            + min(n_words, text_words) * 4 + b * 4 + b * nw_out * 4,
            text_words * 30)


def search_work(kind: str, text, ell, pat, mask, lengths, lim_p, lo0, hi0,
                n_iter: int, bounds: int):
    """What a search needs on this run's data, from the loop run with the
    plain verdicts: (trips per row, bytes, 32-bit ops, bounds).  Bytes:
    each row's pattern and mask once, its window, limits and result, and
    per trip 4 B of ``ell`` plus the text words read up to the compare's
    first difference (and the word a funnel shift or byte pick
    straddles)."""
    from repro_torch.core import packing
    from repro_torch.kernels import ref as kref
    b, nw = pat.shape
    rep = lambda t: t if bounds == 1 else torch.cat([t, t])
    p2, m2, lo, hi = rep(pat), rep(mask), rep(lo0), rep(hi0)
    if kind == "words":
        l2, lp2 = rep(lengths), rep(lengths if lim_p is None else lim_p)
        per_row_in = 2 * nw * 4 + 4 * 4  # pattern, mask, lo, hi, len, lim
    else:
        live = (m2 != 0).sum(1)  # zero mask words skip their load
        per_row_in = 2 * nw * 4 + 2 * 4
    upper = torch.arange(bounds * b, device=lo.device) >= b
    trips = torch.zeros(bounds * b, dtype=torch.int64, device=lo.device)
    text_bytes = 0
    total = ell.shape[0]
    for _ in range(n_iter):
        act = lo < hi
        if not bool(act.any()):
            break
        mid = (lo + hi) // 2
        pos = ell[torch.clamp(mid, 0, total - 1)]
        if kind == "words":
            cmp = kref.pattern_probe_words_ref(text, pos, p2, m2, l2, lp2)
            spw = text.syms_per_word
            sw = kref.range_gather_words_ref(text, pos, nw * spw) & m2
            first = packing.lcp_words(sw, p2, text.bits).to(torch.int64) // spw
            read = torch.clamp(first + 1, max=nw) + 1
        else:
            cmp = kref.pattern_probe_ref(text, pos, p2, m2)
            neq = (kref.range_gather_pack_ref(text, pos, 4 * nw) & m2) != p2
            first = torch.where(neq.any(1), neq.to(torch.uint8).argmax(1),
                                nw).to(torch.int64)
            read = torch.minimum(first + 1, live) + 1
        text_bytes += int((read * 4)[act].sum())
        trips += act
        right = torch.where(upper, cmp <= 0, cmp < 0)
        lo, hi = (torch.where(act & right, mid + 1, lo),
                  torch.where(act & ~right, mid, hi))
    n_trips = int(trips.sum())
    nbytes = b * per_row_in + bounds * b * 4 + n_trips * 4 + text_bytes
    return trips, nbytes, n_trips * (nw * 30 + 20), lo.reshape(bounds, b)


def sorted_pairs(keys: torch.Tensor, offs: torch.Tensor):
    """Offsets ordered by their key rows (unsigned, lexicographic), as
    (left, right) neighbour pairs: long shared prefixes, as adjacent
    suffix-array rows have."""
    from repro_torch.core.packing import to_u64
    from repro_torch.core.prepare import _pair_lanes, _stable_order
    order = _stable_order(_pair_lanes(
        [to_u64(keys[None, :, j]) for j in range(keys.shape[1])]))[0]
    o = offs[order]
    return o[:-1].contiguous(), o[1:].contiguous()


def occurrences(s_dev: torch.Tensor, p) -> torch.Tensor:
    """Every start of ``p`` in the device string, by narrowing the
    candidates one symbol at a time."""
    p = [int(c) for c in p]
    m = len(p)
    n1 = s_dev.shape[0]
    cand = torch.nonzero(s_dev[:max(0, n1 - m + 1)] == p[0]).flatten()
    for j in range(1, m):
        if cand.numel() == 0:
            break
        cand = cand[s_dev[cand + j] == p[j]]
    return cand


def brute_lcp(s_dev: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              chunk: int = 256) -> torch.Tensor:
    """LCP of distinct suffix pairs by symbol compare on the device string
    (the terminal is unique, so every pair differs by its end)."""
    n1 = s_dev.shape[0]
    a = a.to(torch.int64)
    b = b.to(torch.int64)
    out = torch.zeros_like(a)
    pending = torch.arange(a.numel(), device=a.device)
    ar = torch.arange(chunk, device=a.device)
    while pending.numel():
        base = out[pending, None] + ar
        ia = torch.clamp(a[pending, None] + base, max=n1 - 1)
        ib = torch.clamp(b[pending, None] + base, max=n1 - 1)
        neq = s_dev[ia] != s_dev[ib]
        first = torch.where(neq.any(1), neq.to(torch.uint8).argmax(1), chunk)
        out[pending] += first
        pending = pending[first == chunk]
    return out


def assert_equal(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    if got.shape != want.shape or not torch.equal(got, want):
        bad = int((got != want).sum()) if got.shape == want.shape else -1
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version ({bad} entries differ)")


def brute_force(s_dev: torch.Tensor, p: np.ndarray) -> np.ndarray:
    """Every start of ``p`` in the device string, by a full scan."""
    m = len(p)
    n1 = s_dev.shape[0]
    match = torch.ones(n1 - m + 1, dtype=torch.bool, device=s_dev.device)
    for j, c in enumerate(p.tolist()):
        match &= s_dev[j:n1 - m + 1 + j] == c
    return torch.nonzero(match).flatten().cpu().numpy()


def check_index(dev, s, s_dev, pats, what: str) -> dict:
    """``ell`` a permutation of the suffixes, ``find_batch`` == scan."""
    hist = torch.bincount(dev.ell.to(torch.int64), minlength=len(s))
    if dev.n_leaves != len(s) or hist.numel() != len(s) or \
            not bool((hist == 1).all()):
        raise AssertionError(f"{what}: ell is not a permutation of 0..n")
    t0 = time.perf_counter()
    found = dev.find_batch(pats)
    t_find = time.perf_counter() - t0
    hits = 0
    for p, got_pos in zip(pats, found):
        want_pos = brute_force(s_dev, p)
        if not np.array_equal(got_pos, want_pos):
            raise AssertionError(f"{what}: find_batch disagrees with the "
                                 f"brute-force scan for pattern {p.tolist()}")
        hits += int(want_pos.size)
    return {"ell_permutation": True, "patterns": len(pats),
            "occurrences": hits, "t_find_batch_s": t_find}


def require_launches(counts: dict, kernels, what: str) -> None:
    for name in kernels:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was never launched on {what}")


def search_batch_launches(search, kernel: str, what: str) -> None:
    """One search batch launches its search kernel once and no
    single-step probe: counted from 0 around one call."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    search()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    steps = {k: counts[k] for k in ("pattern_probe_words", "pattern_probe",
                                    "pattern_probe_packed")}
    emit({"phase": "search_launches", "path": what, "kernel": kernel,
          "search_launches_per_batch": counts[kernel],
          "single_step_probe_launches": steps})
    if counts[kernel] != 1 or any(steps.values()):
        raise AssertionError(f"{what}: a search batch launched {kernel} "
                             f"{counts[kernel]} times and the single-step "
                             f"probes {steps}")


def counts_now() -> dict:
    """``ops.launch_counts()`` plus the rows and words that the three
    elastic-range gathers' counted launches gathered (their time scales
    with them, so ROADMAP queue B ranks them by them, not by launches
    alone)."""
    from repro_torch.kernels import ops
    return {**ops.launch_counts(),
            **{f"{k}_{t}": getattr(ops.KERNELS[k], t)
               for k in GATHERS for t in ("rows", "words")}}


def kernel_of(key: str) -> str | None:
    """The port kernel (``ops.KERNELS`` name) a profiler event belongs to:
    the longest kernel name that begins the event's function name."""
    import re
    from repro_torch.kernels import ops
    m = re.search(r"([A-Za-z_]\w*)\s*[<(]", key)
    base = m.group(1) if m else key
    names = [k for k in ops.KERNELS if base.startswith(k)]
    return max(names, key=len) if names else None


def attention_work(b: int, sq: int, sk: int, h: int, kv: int, d: int,
                   itemsize: int) -> tuple[float, float]:
    """Bytes (q, k, v in, out written once) and FLOPs (QK^T and PV over the
    key positions each row sees) of one causal attention call."""
    pairs = sum(min(i + 1, sk) for i in range(sq))
    return ((2 * b * sq * h * d + 2 * b * sk * kv * d) * itemsize,
            4.0 * b * h * pairs * d)


def flash_parity(cuda) -> list:
    """``flash_attention`` against ``flash_attention_ref`` on the card, float32
    matrix products in full precision (TF32 off, set here).  Tolerances:
    float32 rtol 1e-5 / atol 2e-5 (the JAX test's own: the online softmax
    sums in another order); bfloat16 ``BF16_TOL``, one bf16 ulp of each
    output.  A case with a ninth field scales q by it before the cast."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # (B, Sq, Sk, H, KV, D, causal, dtype[, q scale])
        (2, 128, 128, 4, 2, 32, True, f32),    # tests/test_flash_and_packed.py
        (1, 256, 256, 8, 8, 64, True, f32),
        (2, 128, 128, 4, 1, 32, False, f32),
        (1, 64, 64, 2, 2, 16, True, f32),
        (2, 96, 96, 4, 4, 32, True, f32),
        (1, 128, 128, 4, 2, 32, True, bf16),   # its bf16 case
        (2, 64, 128, 4, 2, 32, True, f32),     # Sq != Sk
        (2, 200, 77, 4, 2, 48, True, f32),
        (1, 1000, 1000, 4, 2, 128, True, f32),  # a ragged length
        (1, 300, 300, 8, 2, 256, True, f32),   # D 256
        (1, 300, 300, 8, 2, 256, False, bf16),
        # the edges of the bf16 wgmma + TMA kernel's 64-row, 64-key and
        # 64-column tiles and of its two warpgroups
        (1, 192, 192, 4, 4, 128, True, bf16),  # GQA group 1
        (2, 160, 160, 8, 2, 64, True, bf16),   # group 4
        (1, 256, 256, 8, 1, 128, True, bf16),  # group 8
        (2, 100, 100, 4, 2, 16, True, bf16),   # D 16
        (1, 130, 130, 4, 2, 48, False, bf16),  # D 48
        (2, 150, 150, 4, 2, 80, True, bf16),   # D 80
        (1, 300, 300, 8, 2, 256, True, bf16),  # D 256
        (2, 1, 300, 8, 2, 128, True, bf16),    # Sq 1
        (1, 1000, 1000, 4, 2, 128, True, bf16),  # Sq not a multiple of 64
        (2, 50, 40, 4, 2, 64, True, bf16),     # Sk < 64
        (1, 65, 300, 4, 2, 128, True, bf16),   # Sq < Sk
        (1, 300, 65, 4, 2, 128, True, bf16),   # Sq > Sk
        (2, 300, 300, 8, 2, 128, True, bf16, 8.0),  # q x 8: the max moves
        (4, 2048, 2048, 16, 8, 128, True, bf16),  # qwen3-1.7b's prefill
        (4, 2048, 2048, 16, 8, 128, True, f32),
    ]
    gen = torch.Generator(device=cuda).manual_seed(5)
    out = []
    for b, sq, sk, h, kv, d, causal, dtype, *q_scale in cases:
        q, k, v = (torch.randn(shape, generator=gen, device=cuda)
                   for shape in ((b, sq, h, d), (b, sk, kv, d),
                                 (b, sk, kv, d)))
        if q_scale:
            q = q * q_scale[0]
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        got = ops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        design = ops.flash_attention.route
        if design != ("wgmma_tma" if dtype == bf16 else "cuda_cores"):
            raise AssertionError(f"flash_attention ran {design} for {dtype}")
        want = kref.flash_attention_ref(q, k, v, causal)
        tol = (1e-5, 2e-5) if dtype == f32 else BF16_TOL
        err = float((got.float() - want.float()).abs().max())
        case = {"phase": "parity", "kernel": "flash_attention",
                "shape": [b, sq, sk, h, kv, d], "causal": causal,
                "dtype": str(dtype).replace("torch.", ""), "design": design,
                "q_scale": q_scale[0] if q_scale else 1.0,
                "max_abs_err": err,
                "rtol": tol[0], "atol": tol[1], "tf32": False}
        emit(case)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol[0],
                                   atol=tol[1])
        out.append(case)
        del q, k, v, got, want
    return out


def lm_serving(cuda):
    """``serve(LM_ARCH)`` at full width in bf16 on the card, 4 prompts of
    2048 tokens and 32 generated, twice (the first warms the libraries),
    then once under ``torch.profiler``: times, peak memory above what
    earlier phases hold, flash launches per step kind, and the device time
    by kernel.
    The decode step is wrapped to read the launch count around each call
    and the cache position it returns; the path itself is unchanged."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.registry import get_config
    cfg = get_config(LM_ARCH)
    batch, prompt_len, gen = 4, 2048, 32
    real_step = serve_mod.step_lib.make_decode_step
    seen = {"decode_launches": 0, "pos": None}

    def counted_step(cfg_, **kw):
        step = real_step(cfg_, **kw)

        def run(params, tokens, cache):
            before = ops.launch_counts()["flash_attention"]
            nxt, cache = step(params, tokens, cache)
            seen["decode_launches"] += (ops.launch_counts()["flash_attention"]
                                        - before)
            seen["pos"] = cache["pos"]
            return nxt, cache
        return run

    serve_mod.step_lib.make_decode_step = counted_step
    runs = []
    try:
        for name in ("cold", "warm", "profiled"):
            ops.reset_launch_counts()
            seen.update(decode_launches=0, pos=None)
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()  # left by earlier phases
            # device activity only: summarizing a CPU op trace of the
            # decode's ~10^5 ops took a minute
            ctx = (profile(activities=[ProfilerActivity.CUDA])
                   if name == "profiled" else contextlib.nullcontext())
            t0 = time.perf_counter()
            with ctx as prof:
                tokens, st = serve_mod.serve(
                    LM_ARCH, smoke=False, batch=batch, prompt_len=prompt_len,
                    gen=gen, dtype=torch.bfloat16)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = counts_now()
            flash = counts["flash_attention"]
            row = {"phase": "lm_serving", "run": name, "arch": LM_ARCH,
                   "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                   "params": cfg.param_count(), "dtype": "bfloat16",
                   "batch": batch, "prompt_len": prompt_len, "gen": gen,
                   **st, "wall_s": wall,
                   "prefill_tok_s": batch * prompt_len / st["t_prefill_s"],
                   "peak_memory_gb": (torch.cuda.max_memory_allocated()
                                      - held) / 1e9,
                   "held_before_gb": held / 1e9,
                   "flash_launches_prefill": flash - seen["decode_launches"],
                   "flash_launches_decode": seen["decode_launches"],
                   "flash_design": ops.flash_attention.route,
                   "pos": seen["pos"], "launches": counts}
            if prof is not None:
                row.update(device_breakdown(
                    prof, st["t_prefill_s"] + st["t_decode_s"]))
            emit(row)
            toks = tokens.cpu()
            if (row["flash_launches_prefill"] != cfg.n_layers
                    or seen["decode_launches"] != 0
                    or row["flash_design"] != "wgmma_tma"):
                raise AssertionError(f"lm_serving: flash_attention launched "
                                     f"{row['flash_launches_prefill']} times "
                                     f"in the prefill (want {cfg.n_layers}) "
                                     f"and {seen['decode_launches']} in the "
                                     f"decode (want 0), the last through "
                                     f"{row['flash_design']} (want "
                                     f"wgmma_tma)")
            if (toks.shape != (batch, gen) or toks.dtype != torch.int32
                    or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab):
                raise AssertionError("lm_serving: tokens out of the vocabulary")
            if seen["pos"] != prompt_len + gen - 1:
                raise AssertionError(f"lm_serving: cache pos {seen['pos']}, "
                                     f"want {prompt_len + gen - 1}")
            runs.append(row)
    finally:
        serve_mod.step_lib.make_decode_step = real_step
    return runs


def device_events(prof) -> list[tuple[float, str, int]]:
    """(ms, name, calls) of every device-side event (kernels, copies and
    sets) a profile recorded.  A host op such as ``aten::sort`` also
    reports the device time of the kernels it launched, so summing every
    row of ``key_averages()`` would count those kernels twice."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us and getattr(e, "device_type", DeviceType.CUDA) != DeviceType.CPU:
            rows.append((us / 1e3, e.key, e.count))
    return rows


def device_breakdown(prof, span_s: float, top: int | None = 8) -> dict:
    """Device milliseconds and calls by kernel name (the ``top`` largest;
    every one for None) and the device's busy share of ``span_s``: for
    ``serve`` the prefill and decode seconds it timed (the device total
    also holds the few ms of parameter init), for a build its wall."""
    rows = sorted(device_events(prof), reverse=True)
    total = sum(r[0] for r in rows)
    return {"device_ms": total,
            "device_busy_share": total / (span_s * 1e3) if total else None,
            "top_kernels": [{"name": k[:80], "ms": ms, "calls": c,
                             "kernel": kernel_of(k)}
                            for ms, k, c in rows[:top]]}


def lm_check(cuda):
    """Decode against prefill in float32 at full width, batch 2, prompt
    512: the logits of decode step j (``_sdpa`` over the cache) against
    the last-position logits of a fresh prefill over prompt + the j tokens
    decoded before (the ``flash_attention`` kernel, at a ragged length);
    then a 2-layer
    full-width prefill on the card against the same parameters on the CPU
    (plain versions).  Tolerances (float32 over 28 and 2 layers, sums in
    another order on the card and the CPU): see LM_TOL and CPU_TOL."""
    import dataclasses
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(LM_ARCH)
    batch, prompt_len, steps = 2, 512, (1, 8)
    ops.reset_launch_counts()
    params = T.init_params(1, cfg, torch.float32, cuda)
    rng = np.random.default_rng(21)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, size=(batch, prompt_len), dtype=np.int32)).to(cuda)
    jmax = max(steps)
    cache = T.init_cache(cfg, batch, prompt_len + jmax + 1, torch.float32, cuda)
    logits, cache = T.forward_prefill(params, {"tokens": prompt}, cfg, cache)
    fed = [torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]]
    results = []
    for j in range(1, jmax + 1):
        dec_logits, cache = T.forward_decode(params, fed[-1], cfg, cache)
        if j in steps:
            seq = torch.cat([prompt] + fed, dim=1)
            fresh = T.init_cache(cfg, batch, seq.shape[1], torch.float32, cuda)
            want, _ = T.forward_prefill(params, {"tokens": seq}, cfg, fresh)
            del fresh
            got, want = dec_logits[:, -1], want[:, -1]
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            results.append({"step": j, "prefill_len": seq.shape[1],
                            "max_abs_err": err, "max_abs_logit": scale,
                            "rel_err": err / scale,
                            "argmax_equal": bool(torch.equal(
                                got.argmax(-1), want.argmax(-1)))})
            if not torch.isfinite(got).all() or err > LM_TOL * scale:
                raise AssertionError(f"lm_check: decode step {j} differs from "
                                     f"the prefill by {err} (max |logit| "
                                     f"{scale}, tolerance {LM_TOL} of it)")
        fed.append(torch.argmax(dec_logits[:, -1], -1).to(torch.int32)[:, None])
    counts = counts_now()
    emit({"phase": "lm_check", "what": "decode vs prefill", "arch": LM_ARCH,
          "dtype": "float32", "n_layers": cfg.n_layers, "batch": batch,
          "prompt_len": prompt_len, "steps": results, "tolerance": LM_TOL,
          "flash_launches": counts["flash_attention"]})
    if counts["flash_attention"] != cfg.n_layers * (1 + len(steps)):
        raise AssertionError("lm_check: every prefill layer must run "
                             "flash_attention")
    del cache, logits

    # 2 layers of the same parameters, on the card and on the CPU
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    p2 = dict(params, layers={k: _slice_tree(v, 2)
                              for k, v in params["layers"].items()})
    del params
    torch.cuda.empty_cache()
    got, _ = T.forward_prefill(p2, {"tokens": prompt}, cfg2, T.init_cache(
        cfg2, batch, prompt_len, torch.float32, cuda))
    p_cpu = _to_device(p2, "cpu")
    del p2
    torch.cuda.empty_cache()
    want, _ = T.forward_prefill(p_cpu, {"tokens": prompt.cpu()}, cfg2,
                                T.init_cache(cfg2, batch, prompt_len,
                                             torch.float32, "cpu"))
    got = got.cpu()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    emit({"phase": "lm_check", "what": "card vs cpu", "arch": LM_ARCH,
          "dtype": "float32", "n_layers": 2, "batch": batch,
          "prompt_len": prompt_len, "max_abs_err": err, "max_abs_logit": scale,
          "rel_err": err / scale, "rtol": CPU_TOL[0], "atol_rel": CPU_TOL[1]})
    torch.testing.assert_close(got, want, rtol=CPU_TOL[0],
                               atol=CPU_TOL[1] * scale)


def flash_row(cuda, cases: list) -> dict:
    """``flash_attention`` at the prefill shape of qwen3-1.7b (bf16, B 4,
    S 2048, H 16, KV 8, D 128, causal): its time, the plain version's, SDPA's
    on the same inputs, and the bound (FLOPs over the bf16 tensor-core
    peak, or bytes over the memory rate, whichever is larger)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    b, s, h, kv, d = 4, 2048, 16, 8, 128
    gen = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn((b, s, h, d), generator=gen, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((b, s, kv, d), generator=gen, device=cuda
                        ).to(torch.bfloat16) for _ in range(2))
    nbytes, flops = attention_work(b, s, s, h, kv, d, 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    path = [c for c in cases if c["shape"] == [b, s, s, h, kv, d]
            and c["dtype"] == "bfloat16"]
    # 10 back-to-back calls a window: the wrapper's host work (three
    # tensor-map encodes) overlaps the device, as in the prefill
    ms = cuda_ms(lambda: ops.flash_attention(q, k, v), inner=10)
    if ops.flash_attention.route != "wgmma_tma":
        raise AssertionError("bf16 flash_attention did not run wgmma_tma")
    return {"name": "flash_attention",
            "replaces": "src/repro/kernels/flash_attention.py:73",
            "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
            "design": "wgmma_tma",
            "shape": f"B={b} S={s} H={h} KV={kv} D={d} causal bf16",
            "ms": ms,
            "plain_ms": cuda_ms(
                lambda: kref.flash_attention_ref(q, k, v, True)),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True), inner=10),
            "library": "torch.nn.functional.scaled_dot_product_attention"
                       "(is_causal=True, enable_gqa=True)",
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": path[0]["max_abs_err"]}


def _slice_tree(tree, n: int):
    if isinstance(tree, torch.Tensor):
        return tree[:n]
    return {k: _slice_tree(v, n) for k, v in tree.items()}


def _to_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return {k: _to_device(v, device) for k, v in tree.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-log2", type=int, default=27,
                    help="index the genome and protein datasets at n = 2**N")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import build as tbuild
    from repro_torch.core import packing
    from repro_torch.core.alphabet import ALPHABETS
    from repro_torch.core.api import BuildReport, EraConfig, EraIndexer
    from repro_torch.core.prepare import PrepareStats, _pair_lanes, _stable_order
    from repro_torch.core.query import _pack_query_batch
    from repro_torch.core.vertical import VerticalStats
    from repro_torch.data.strings import dataset, synthetic_string
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import ref as kref
    from repro_torch.launch.analytics_serve import make_query, serve_engine
    from repro_torch.launch import gather_bench, hist_lcp_bench
    from repro_torch.launch.gather_bench import persisting_l2_window
    from repro_torch.launch.query_serve import make_workload, serve_index
    from repro_torch.launch.serving import (
        AsyncServer,
        ServeConfig,
        make_hot_workload,
        run_closed_loop,
    )

    cuda = torch.device("cuda")

    def dram_round_trip_ms() -> float:
        """Milliseconds of one dependent device-memory round trip
        (``csrc/dram_latency.cu``): a single thread's walk of a random
        cycle over 2^23 nodes 128 B apart (1 GiB, 20x the L2), 2^17 links a
        launch, each launch resuming where the last stopped (no line is
        visited twice), per link, the median of 5 CUDA-event windows."""
        nodes, stride, hops = 1 << 23, 32, 1 << 17
        gen = torch.Generator(device=cuda).manual_seed(5)
        perm = torch.randperm(nodes, device=cuda, generator=gen)
        nxt = torch.zeros(nodes * stride, dtype=torch.int32, device=cuda)
        nxt[perm * stride] = (torch.roll(perm, -1) * stride).to(torch.int32)
        node = (perm[:1] * stride).to(torch.int32)
        fn = _build.entry("dram_latency", [ctypes.c_void_p, ctypes.c_longlong,
                                           ctypes.c_void_p, ctypes.c_void_p])
        stream = torch.cuda.current_stream().cuda_stream
        ms = cuda_ms(lambda: _build.check(fn(
            nxt.data_ptr(), hops, node.data_ptr(), stream),
            "dram_latency")) / hops
        del nxt, perm, node
        torch.cuda.empty_cache()
        return ms

    def fused_reads(kind: str, ptx, pos, pat, mask, nw_out: int) -> int:
        """Text words the fused kernel reads for these rows: each row reads
        until its window is written and its verdict is decided, plus the
        word its funnel shift straddles."""
        spw, nw_pat = ptx.syms_per_word, pat.shape[1]
        if kind == "words":
            sw = kref.range_gather_words_ref(ptx, pos, nw_pat * spw) & mask
            first = packing.lcp_words(sw, pat, ptx.bits).to(torch.int64) // spw
        else:
            neq = (kref.range_gather_packed_ref(ptx, pos, 4 * nw_pat)
                   & mask) != pat
            first = torch.where(neq.any(1), neq.to(torch.uint8).argmax(1),
                                nw_pat).to(torch.int64)
        need = torch.clamp(torch.clamp(first + 1, max=nw_pat), min=nw_out)
        if kind == "packed":
            need = -(-4 * need // spw)
        return int((need + 1).sum())

    def fused_case(kind: str, ptx, pos, pat, mask, lengths, fetch: int,
                   inner: int) -> dict:
        """A fused kernel against its plain version and against the two
        ported kernels it fuses, launched one after the other (exact);
        the three times and the bound."""
        if kind == "words":
            nw_out, n_in = -(-fetch // ptx.syms_per_word), 2
            fused = lambda: ops.probe_gather_words(ptx, pos, pat, mask,
                                                   lengths, fetch)
            plain = lambda: kref.probe_gather_words_ref(
                ptx, pos, pat, mask, lengths, fetch=fetch)
            two = lambda: (ops.pattern_probe_words(ptx, pos, pat, mask,
                                                   lengths),
                           ops.range_gather_words(ptx, pos, fetch))
        else:
            nw_out, n_in = fetch // 4, 1
            fused = lambda: ops.probe_gather_packed(ptx, pos, pat, mask, fetch)
            plain = lambda: kref.probe_gather_packed_ref(ptx, pos, pat, mask,
                                                         fetch=fetch)
            two = lambda: (ops.pattern_probe_packed(ptx, pos, pat, mask),
                           ops.range_gather_packed(ptx, pos, fetch))
        got = fused()
        for g, p_, t_, part in zip(got, plain(), two(), ("verdict", "window")):
            assert_equal(g, p_, f"probe_gather_{kind} {part}")
            assert_equal(g, t_, f"probe_gather_{kind} {part} vs two launches")
        b_ms, b_by = bound(*fused_work(
            pos.shape[0], pat.shape[1], nw_out,
            fused_reads(kind, ptx, pos, pat, mask, nw_out),
            ptx.words.shape[0], n_in))
        return {"rows": pos.shape[0], "nw_pat": pat.shape[1], "fetch": fetch,
                "max_abs_err": 0,
                "verdicts": {str(v): int((got[0] == v).sum())
                             for v in (-1, 0, 1)},
                "ms": cuda_ms(fused, inner=inner),
                "plain_ms": cuda_ms(plain, inner=max(1, inner // 5)),
                "two_launch_ms": cuda_ms(two, inner=inner),
                "bound_ms": b_ms, "bound_by": b_by}

    def fused_parity(name: str, ptx, sx: np.ndarray, ax) -> None:
        """Both fused kernels on 4096 rows of a dense text (suffixes that
        run into the terminal included), fetch wider and narrower than the
        pattern; word rows hold real symbols, byte-key rows planted
        suffixes of the terminal-padded string."""
        nr = ptx.n_real
        b = 4096
        sp_x = ax.pad_string(sx, extra=64)
        for m, fetch in ((8, 32), (16, 4), (24, 32), (64, 16)):
            pos_np = rng.integers(0, nr + 1, size=b).astype(np.int32)
            pos_np[-64:] = rng.integers(max(0, nr - m), nr + 1, size=64)
            lens = torch.from_numpy(
                rng.integers(1, m + 1, size=b).astype(np.int32)).to(cuda)
            sym = rng.integers(0, len(ax.symbols),
                               size=(b, m)).astype(np.int32)
            sym_t = sym.copy()
            for i in range(0, b, 2):
                p = int(pos_np[i])
                seg = sx[p:min(p + m, nr)]
                sym[i, :seg.size] = seg
                sym_t[i] = sp_x[p:p + m]
            pos = torch.from_numpy(pos_np).to(cuda)
            rows = {"words": _pack_query_batch(
                        ptx, torch.from_numpy(sym).to(cuda), lens),
                    "packed": _pack_query_batch(
                        None, torch.from_numpy(sym_t).to(cuda), lens,
                        word=False)}
            for kind, (pat, mask) in rows.items():
                emit({"phase": "parity", "kernel": f"probe_gather_{kind}",
                      "text": name, "bits": ptx.bits, "m_pad": m,
                      **fused_case(kind, ptx, pos, pat, mask, lens, fetch,
                                   inner=20)})

    def check_find_fetch(dev, s_dev: torch.Tensor, pats, what: str):
        """``find_fetch_batch``: ranges equal ``find_batch`` and the scan,
        each window equals the text at its first match read on the card
        (the terminal past the end), −1 where nothing matched, and the
        fused verdict is 0 wherever the pattern occurs.  Returns the
        checks and the launch counts of the two find-and-fetch calls alone
        (counted from 0)."""
        n1 = s_dev.shape[0]
        found = dev.find_batch(pats)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        ranges, wins = dev.find_fetch_batch(pats, fetch=FETCH)
        t_ff = time.perf_counter() - t0
        padded, lengths, route = dev.pad_batch(pats)
        start, count, win, verified = dev.find_fetch_ranges(
            padded, lengths, route, fetch=FETCH)
        counts = counts_now()
        hits = 0
        for p, r, f in zip(pats, ranges, found):
            want = brute_force(s_dev, np.asarray(p))
            if not (np.array_equal(r, f) and np.array_equal(r, want)):
                raise AssertionError(f"{what}: find_fetch_batch disagrees "
                                     f"with find_batch or the scan for "
                                     f"pattern {np.asarray(p).tolist()}")
            hits += int(want.size)
        has = count > 0
        if not np.array_equal(win.cpu().numpy(), wins):
            raise AssertionError(f"{what}: find_fetch_batch and "
                                 f"find_fetch_ranges disagree")
        if bool((verified[has] != 0).any()):
            raise AssertionError(f"{what}: a matched row failed the fused "
                                 f"verdict")
        pos0 = dev.ell[torch.clamp(start, 0, dev.n_leaves - 1)].to(torch.int64)
        idx = torch.clamp(pos0[:, None] + torch.arange(FETCH, device=cuda),
                          max=n1 - 1)
        want_win = torch.where(has[:, None], s_dev[idx].to(torch.int32), -1)
        if not torch.equal(win, want_win):
            raise AssertionError(f"{what}: a fetched window differs from "
                                 f"the text at its match")
        return {"patterns": len(pats), "matched": int(has.sum()),
                "occurrences": hits, "fetch": FETCH,
                "windows_past_end": int(((pos0 + FETCH > n1 - 1) & has).sum()),
                "t_find_fetch_batch_s": t_ff}, counts

    @contextlib.contextmanager
    def search_as_loop():
        """The search kernels swapped for the loop they replace (n_iter
        single-step probe launches and the small ops around each), the
        yardstick of an end-to-end search."""
        saved = ops.search_bounds_words, ops.search_bounds_bytes
        ops.search_bounds_words = (
            lambda pt, ell, pat, mask, lengths, lim_p, lo0, hi0, **kw:
            ops.search_loop(ops.pattern_probe_words, pt, ell, pat, mask,
                            lengths, lim_p, lo0, hi0, **kw))
        ops.search_bounds_bytes = (
            lambda sp, ell, pat, mask, lo0, hi0, **kw: ops.search_loop(
                ops.pattern_probe, sp, ell, pat, mask, None, None, lo0, hi0,
                **kw))
        try:
            yield
        finally:
            ops.search_bounds_words, ops.search_bounds_bytes = saved

    @contextlib.contextmanager
    def fetch_unfused():
        """The fused find-and-fetch kernels swapped for what they replace:
        the search kernel, then the epilogue kernels (``probe_gather_words``
        on dense words, ``pattern_probe`` + ``range_gather_pack`` on the
        byte string) and the torch ops of the decode
        (``search.fetch_composition`` with the ported kernels)."""
        from repro_torch.kernels.search import fetch_composition
        saved = ops.search_fetch_words, ops.search_fetch_bytes
        ops.search_fetch_words = (
            lambda pt, ell, pat, mask, lengths, lo0, hi0, **kw:
            fetch_composition(pt, ell, pat, mask, lengths, lo0, hi0,
                              word=True, plain=False, **kw))
        ops.search_fetch_bytes = (
            lambda sp, ell, pat, mask, lo0, hi0, **kw: fetch_composition(
                sp, ell, pat, mask, None, lo0, hi0, word=False, plain=False,
                **kw))
        try:
            yield
        finally:
            ops.search_fetch_words, ops.search_fetch_bytes = saved

    def fetch_latency(dev, pats) -> dict:
        """Host milliseconds from dispatch to a synchronised result of the
        search alone (``find_batch_ranges``), of the same search through
        the loop of single-step probes the search kernels replace, of
        find-and-fetch (``find_fetch_ranges``, one fused launch) and of
        find-and-fetch through the search and epilogue kernels it fuses,
        on the same padded batch: medians of 20 runs each, taken in turns
        after one warm-up of each."""
        padded, lengths, route = dev.pad_batch(pats)

        def loop_ranges():
            with search_as_loop():
                return dev.find_batch_ranges(padded, lengths, route)

        def unfused_fetch():
            with fetch_unfused():
                return dev.find_fetch_ranges(padded, lengths, route,
                                             fetch=FETCH)

        calls = {"find_batch_ranges_ms": lambda: dev.find_batch_ranges(
                     padded, lengths, route),
                 "find_batch_ranges_loop_ms": loop_ranges,
                 "find_fetch_ranges_ms": lambda: dev.find_fetch_ranges(
                     padded, lengths, route, fetch=FETCH),
                 "find_fetch_ranges_unfused_ms": unfused_fetch}
        for got, want, part in zip(calls["find_batch_ranges_ms"](),
                                   loop_ranges(), ("start", "count")):
            assert_equal(got, want, f"find_batch_ranges {part} against the "
                                    f"loop of single-step probes")
        for got, want, part in zip(calls["find_fetch_ranges_ms"](),
                                   unfused_fetch(),
                                   ("start", "count", "window", "verified")):
            assert_equal(got, want, f"find_fetch_ranges {part} against the "
                                    f"search and epilogue kernels it fuses")
        times = {k: [] for k in calls}
        for _ in range(21):
            for k, fn in calls.items():
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times[k].append(time.perf_counter() - t0)
        return {k: float(np.median(v[1:])) * 1e3 for k, v in times.items()}

    def require_fetch(counts: dict, path: str, what: str) -> None:
        require_launches(counts, FETCH_KERNELS[path], what)
        for name in FETCH_ABSENT[path]:
            if counts[name]:
                raise AssertionError(f"{name} was launched on {what}")

    class SyncFreeServer(AsyncServer):
        """An AsyncServer whose every ``_dispatch`` runs under
        ``torch.cuda.set_sync_debug_mode("error")`` (any call that
        synchronises the host with the card raises) and launches exactly
        one kernel, ``kernel``, when its batch has rows to search (none
        when the cache answered it all), with the host seconds of each
        dispatch, each wait for a batch's event and each consume after
        it."""

        def __init__(self, *args, kernel: str, **kw):
            super().__init__(*args, **kw)
            self.kernel = kernel
            self.t_dispatch, self.t_wait, self.t_consume = [], [], []

        def _dispatch(self):
            before = ops.launch_counts()
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                flight = super()._dispatch()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            if flight is not None:
                self.t_dispatch.append(time.perf_counter() - t0)
                got = {k: v - before[k]
                       for k, v in ops.launch_counts().items()
                       if v != before[k]}
                if got != ({self.kernel: 1} if flight.n_rows else {}):
                    raise AssertionError(f"a served batch of {flight.n_rows}"
                                         f" rows launched {got}, not one "
                                         f"{self.kernel}")
            return flight

        def _consume(self, flight):
            t0 = time.perf_counter()
            if flight.ready is not None:
                flight.ready.synchronize()
            t1 = time.perf_counter()
            super()._consume(flight)
            self.t_wait.append(t1 - t0)
            self.t_consume.append(time.perf_counter() - t1)

        def host_ms(self) -> dict:
            """Median host milliseconds per batch of each step."""
            return {f"{k}_ms": float(np.median(v)) * 1e3 for k, v in (
                ("dispatch", self.t_dispatch), ("wait", self.t_wait),
                ("consume", self.t_consume))}

    def device_ms(fn) -> float | None:
        """Milliseconds of device time (kernels and copies) that
        ``torch.profiler`` records while ``fn`` runs; None when it records
        none."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ms = sum(r[0] for r in device_events(prof))
        return ms if ms else None

    def serving_stack(dev, sx: np.ndarray, ax, name: str) -> dict:
        """``run_closed_loop`` in sync, async and cached mode, with fetch 0
        and FETCH, on a hot workload; each mode warmed once by a
        sync-free-dispatch pass that checks each batch's one launch, then
        timed; every result of both passes equal to ``find_batch`` /
        ``find_fetch_batch`` on the same patterns.  Returns the launch
        counts of the nine passes of each fetch, by fetch."""
        pats = make_hot_workload(sx, np.random.default_rng(29),
                                 n_requests=SERVE_REQUESTS, hot_pool=32,
                                 hot_frac=0.8, min_len=4, max_len=24,
                                 n_symbols=len(ax.symbols))
        uniq = {}
        for p in pats:
            uniq.setdefault(p.tobytes(), p)
        t0 = time.perf_counter()
        want_pos = dict(zip(uniq, dev.find_batch(list(uniq.values()))))
        ranges, wins = dev.find_fetch_batch(list(uniq.values()), fetch=FETCH)
        for k, r in zip(uniq, ranges):
            if not np.array_equal(r, want_pos[k]):
                raise AssertionError(f"{name}: find_fetch_batch ranges "
                                     f"disagree with find_batch")
        want_win = dict(zip(uniq, wins))
        del ranges
        emit({"phase": "serving_stack", "dataset": name,
              "requests": len(pats), "distinct_patterns": len(uniq),
              "positions_per_pass": sum(want_pos[p.tobytes()].size
                                        for p in pats),
              "t_reference_s": time.perf_counter() - t0})

        def check(res, fetch: int, what: str) -> None:
            seen = set()
            for p, (pos, win) in zip(pats, res):
                k = p.tobytes()
                if (id(pos), k) not in seen:
                    seen.add((id(pos), k))
                    if not np.array_equal(pos, want_pos[k]):
                        raise AssertionError(f"{what}: positions differ "
                                             f"from find_batch")
                if fetch and not np.array_equal(win, want_win[k]):
                    raise AssertionError(f"{what}: a window differs from "
                                         f"find_fetch_batch")
                if not fetch and win is not None:
                    raise AssertionError(f"{what}: a window without fetch")

        counts = {}
        for fetch in (0, FETCH):
            ops.reset_launch_counts()
            kernel = FETCH_KERNELS[name][0] if fetch else SEARCH_KERNELS[name]
            base = None
            for mode, kw in (("sync", dict(pipeline=False, cache_size=0)),
                             ("async", dict(pipeline=True, cache_size=0)),
                             ("cached", dict(pipeline=True, cache_size=4096))):
                cfg = ServeConfig(queue_depth=1024, max_batch=256,
                                  max_wait_ms=1.0, fetch=fetch, **kw)
                what = f"{name} serving {mode} fetch={fetch}"
                t0 = time.perf_counter()
                warm = SyncFreeServer(dev, cfg, kernel=kernel)
                check(warm.serve(pats), fetch, what + " (warm-up)")
                t_warm = time.perf_counter() - t0
                res, st = run_closed_loop(dev, pats, cfg)
                check(res, fetch, what)
                del res
                base = st["qps"] if mode == "sync" else base
                busy = {}
                if fetch:  # a third pass under the profiler: device time
                    d_ms = device_ms(lambda: run_closed_loop(dev, pats, cfg))
                    busy = {"device_ms_per_pass": d_ms,
                            "device_busy_share": None if d_ms is None
                            else d_ms / (st["wall_s"] * 1e3)}
                emit({"phase": "serving_stack", "dataset": name,
                      "mode": mode, "fetch": fetch, "qps": st["qps"],
                      "lat_p50_ms": st["lat_p50_ms"],
                      "lat_p99_ms": st["lat_p99_ms"],
                      "vs_sync": st["qps"] / base,
                      "cache_hit_rate": st["cache"]["hit_rate"],
                      "cache": st["cache"], "batches": st["batches"],
                      "rows_padded": st["rows_padded"],
                      "shapes": st["shapes"], "wall_s": st["wall_s"],
                      "warm_pass_s": t_warm, "warm_pass_host": warm.host_ms(),
                      **busy, "sync_free_dispatch": True,
                      "per_batch_launches": {kernel: 1},
                      "equal_to_find_batch": True})
            counts[fetch] = counts_now()
            emit({"phase": "serving_stack", "dataset": name, "fetch": fetch,
                  "launches": counts[fetch]})
        return counts
    def search_rows(dev, pats, word: bool, m_pad=None):
        """A batch's packed rows and routed windows on the card: (pat,
        mask, lengths, lo0, hi0)."""
        from repro_torch.core.query import _route_window
        padded, lengths, route = dev.pad_batch(pats, m_pad=m_pad)
        t = lambda x: torch.from_numpy(x).to(cuda)
        len_t = t(lengths)
        pat, mask = _pack_query_batch(dev.s_text, t(padded), len_t, word)
        lo0, hi0 = _route_window(dev.win_lo, dev.win_hi, dev.pows, dev.spans,
                                 len_t, t(route), dev.k_route)
        return pat, mask, len_t, lo0.contiguous(), hi0.contiguous()

    def search_parity(kind: str, dev, sx: np.ndarray, ax, name: str) -> dict:
        """A search kernel against the loop with the plain probes, the loop
        of single-step kernels and the counted loop of ``search_work``
        (exact) on the serving batch (256 patterns of 4-24 symbols, routed
        windows) and its edges: unrouted and empty windows, patterns that
        end at the terminal tail, the lower bound alone (words: with a
        pattern limit below the compare length), NW at and past the
        register-template edges, B = 1, B = 0 and 2^20 rows.  Returns the
        kernel's row at the serving shape."""
        kernel = f"search_bounds_{kind}"
        word = kind == "words"
        step = ops.pattern_probe_words if word else ops.pattern_probe
        plain_probe = (kref.pattern_probe_words_ref if word
                       else kref.pattern_probe_ref)
        srng = np.random.default_rng(23)
        n_real = len(sx) - 1
        total = dev.n_leaves

        batch_rows = lambda pats, m_pad=None: search_rows(dev, pats, word,
                                                          m_pad)

        def calls(pat, mask, lengths, lo0, hi0, bounds, lim_p=None):
            kw = dict(n_iter=dev.n_iter, bounds=bounds)
            if word:
                args = (dev.s_text, dev.ell, pat, mask, lengths, lim_p, lo0,
                        hi0)
                fused = lambda: ops.search_bounds_words(*args, **kw)
            else:
                args = (dev.s_text, dev.ell, pat, mask, None, None, lo0, hi0)
                fused = lambda: ops.search_bounds_bytes(
                    dev.s_text, dev.ell, pat, mask, lo0, hi0, **kw)
            return (fused, lambda: ops.search_loop(plain_probe, *args, **kw),
                    lambda: ops.search_loop(step, *args, **kw))

        def case(what, pat, mask, lengths, lo0, hi0, bounds=2, lim_p=None):
            fused, plain, loop = calls(pat, mask, lengths, lo0, hi0, bounds,
                                       lim_p)
            got = fused()
            assert_equal(got, plain(), f"{kernel} {name} {what}")
            assert_equal(got, loop(), f"{kernel} {name} {what} against the "
                                      f"loop of single-step kernels")
            trips, _, _, want = search_work(kind, dev.s_text, dev.ell, pat,
                                            mask, lengths, lim_p, lo0, hi0,
                                            dev.n_iter, bounds)
            assert_equal(got, want, f"{kernel} {name} {what} against the "
                                    f"counted loop")
            emit({"phase": "parity", "kernel": kernel, "text": name,
                  "case": what, "rows": bounds * pat.shape[0],
                  "nw": pat.shape[1], "bounds": bounds, "max_abs_err": 0,
                  "trips_max": int(trips.max()) if trips.numel() else 0,
                  "n_iter": dev.n_iter})

        serving = make_workload(sx, srng, batch=256, min_len=4, max_len=24,
                                planted_frac=0.7, n_symbols=len(ax.symbols))
        pat, mask, lengths, lo0, hi0 = batch_rows(serving)
        case("serving", pat, mask, lengths, lo0, hi0)
        case("unrouted", pat, mask, lengths, torch.zeros_like(lo0),
             torch.full_like(hi0, total))
        empty = torch.randint(0, total + 1, lo0.shape, device=cuda,
                              dtype=torch.int32)
        case("empty", pat, mask, lengths, empty, empty.clone())
        tail = [np.asarray(sx[n_real - k:n_real]) for k in range(1, 25)]
        if not word:  # the byte string: patterns running into the terminal
            tail += [np.append(sx[n_real - k:n_real], ax.terminal_code)
                     .astype(np.uint8) for k in range(24)]
        case("terminal_tail", *batch_rows(tail))
        lim_p = (torch.clamp(lengths - torch.randint_like(lengths, 0, 8),
                             min=0) if word else None)
        case("lower_bound" + ("_lim_p" if word else ""), pat, mask, lengths,
             lo0, hi0, bounds=1, lim_p=lim_p)
        spw = dev.s_text.syms_per_word if word else 4
        for nw in (1, 2, 3, 4, 8, 16, 17, 32 if word else 128):
            pats = []
            for i in range(256):  # lengths that need all nw words
                m = int(srng.integers((nw - 1) * spw + 1, nw * spw + 1))
                if i % 2:
                    p0 = int(srng.integers(0, n_real - m))
                    pats.append(np.asarray(sx[p0:p0 + m]))
                else:
                    pats.append(srng.integers(0, len(ax.symbols), m)
                                .astype(np.uint8))
            case(f"nw={nw}", *batch_rows(pats, m_pad=nw * spw))
        case("B=1", pat[:1], mask[:1], lengths[:1], lo0[:1], hi0[:1])
        case("B=0", pat[:0], mask[:0], lengths[:0], lo0[:0], hi0[:0])
        idx = torch.randint(0, pat.shape[0], (1 << 19,), device=cuda)
        large = (pat[idx].contiguous(), mask[idx].contiguous(), lengths[idx],
                 lo0[idx], hi0[idx])
        case("2^20 rows", *large)

        # the row: the serving batch, both bounds in one launch
        fused, plain, loop = calls(pat, mask, lengths, lo0, hi0, 2)
        trips, nbytes, n_ops, _ = search_work(kind, dev.s_text, dev.ell, pat,
                                              mask, lengths, None, lo0, hi0,
                                              dev.n_iter, 2)
        b_ms, b_by = bound(nbytes, n_ops)
        fl, _, ll = calls(*large, 2)
        trips_l, nbytes_l, n_ops_l, _ = search_work(
            kind, dev.s_text, dev.ell, *large[:3], None, *large[3:],
            dev.n_iter, 2)
        bl_ms, bl_by = bound(nbytes_l, n_ops_l)
        win = (hi0 - lo0).to(torch.float64)
        replaces = ("src/repro/kernels/packed_gather.py:335" if word
                    else "src/repro/kernels/pattern_probe.py:57")
        return {"name": kernel, "replaces": replaces,
                "replaces_loop": "src/repro/core/query.py:114",
                "shape": f"rows={2 * pat.shape[0]} nw={pat.shape[1]} "
                         f"bounds=2 (B={pat.shape[0]})",
                "ms": cuda_ms(fused, inner=100),
                "loop_ms": cuda_ms(loop, inner=10),
                "plain_ms": cuda_ms(plain, inner=2),
                "bound_ms": b_ms, "bound_by": b_by,
                "bound_note": "this run's trips' bytes over 3.35 TB/s; the "
                              "kernel is bound by dependent DRAM latency "
                              "times trips, not bytes",
                # the longest lane's dependent round trips: its window and
                # pattern row, the first ell entry, one per trip
                "latency_bound_ms": (int(trips.max()) + 2) * dram_rt_ms,
                "trips_max": int(trips.max()),
                "trips_mean": float(trips.to(torch.float64).mean()),
                "n_iter": dev.n_iter, "window_max": int(win.max()),
                "window_mean": float(win.mean()),
                "large": {"shape": f"rows={2 * large[0].shape[0]} "
                                   f"nw={pat.shape[1]} bounds=2",
                          "ms": cuda_ms(fl, inner=5),
                          "loop_ms": cuda_ms(ll, inner=1),
                          "bound_ms": bl_ms, "bound_by": bl_by,
                          "trips_mean": float(trips_l.to(torch.float64)
                                              .mean())}}

    def fetch_parity(kind: str, dev, sx: np.ndarray, ax, name: str) -> dict:
        """A fused find-and-fetch kernel against its plain version
        (``search.fetch_composition`` with the plain probes) and the search
        and epilogue kernels it fuses (exact, all four outputs) on the
        find-and-fetch batch (256 patterns of 4-24 symbols, routed windows,
        fetch 32) and its edges: patterns at the text's end (windows past
        n_real), empty windows, fetch narrower and wider than the pattern,
        NW past the register templates, B = 1, B = 33, B = 0 and 2^20
        lanes (2^19 patterns).  Returns the kernel's row."""
        from repro_torch.kernels.search import fetch_composition
        kernel = f"search_fetch_{kind}"
        word = kind == "words"
        frng = np.random.default_rng(31)
        n_real = len(sx) - 1
        total = dev.n_leaves

        def calls(pat, mask, lengths, lo0, hi0, fetch):
            kw = dict(n_iter=dev.n_iter, fetch=fetch)
            if word:
                fused = lambda: ops.search_fetch_words(
                    dev.s_text, dev.ell, pat, mask, lengths, lo0, hi0, **kw)
            else:
                fused = lambda: ops.search_fetch_bytes(
                    dev.s_text, dev.ell, pat, mask, lo0, hi0, **kw)
            comp = lambda plain: fetch_composition(
                dev.s_text, dev.ell, pat, mask, lengths if word else None,
                lo0, hi0, word=word, plain=plain, **kw)
            return fused, lambda: comp(True), lambda: comp(False)

        def case(what, pat, mask, lengths, lo0, hi0, fetch=FETCH):
            fused, plain, unfused = calls(pat, mask, lengths, lo0, hi0, fetch)
            got = fused()
            for g, p_, u, part in zip(got, plain(), unfused(),
                                      ("start", "count", "window",
                                       "verified")):
                assert_equal(g, p_, f"{kernel} {name} {what} {part}")
                assert_equal(g, u, f"{kernel} {name} {what} {part} against "
                                   f"the kernels it fuses")
            emit({"phase": "parity", "kernel": kernel, "text": name,
                  "case": what, "patterns": pat.shape[0],
                  "nw": pat.shape[1], "fetch": fetch, "max_abs_err": 0,
                  "matched": int((got[1] > 0).sum())})

        def work(pat, mask, lengths, lo0, hi0, fetch):
            """(bytes, ops, longest trips) of the fused kernel on this run's
            data: the search's (``search_work``) less its (2, B) result,
            plus per pattern the ell entry at its lower bound, the text its
            verdict and window read (each word once, and the word a shift
            or byte pick straddles) and the four outputs."""
            trips, nbytes, n_ops, bnd = search_work(
                kind, dev.s_text, dev.ell, pat, mask, lengths, None, lo0,
                hi0, dev.n_iter, 2)
            b, nw = pat.shape
            pos0 = dev.ell[torch.clamp(bnd[0], 0, total - 1)]
            if word:
                nw_out = -(-fetch // dev.s_text.syms_per_word)
                text = 4 * fused_reads("words", dev.s_text, pos0, pat, mask,
                                       nw_out)
            else:
                neq = (kref.range_gather_pack_ref(dev.s_text, pos0, 4 * nw)
                       & mask) != pat
                first = torch.where(neq.any(1), neq.to(torch.uint8).argmax(1),
                                    nw).to(torch.int64)
                verdict = torch.minimum(first + 1, (mask != 0).sum(1))
                text = int(((torch.clamp(verdict, min=fetch // 4) + 1)
                            * 4).sum())
            nbytes += b * 4 + text + b * (fetch + 3) * 4 - 2 * b * 4
            return (nbytes, n_ops + b * (nw * 30 + fetch * 6),
                    int(trips.max()) if trips.numel() else 0)

        serving = make_workload(sx, frng, batch=256, min_len=4, max_len=24,
                                planted_frac=0.7, n_symbols=len(ax.symbols))
        rows_b = search_rows(dev, serving, word)
        pat, mask, lengths, lo0, hi0 = rows_b
        case("fetch", *rows_b)
        tail = [np.asarray(sx[n_real - k:n_real]) for k in range(1, 25)]
        if not word:  # the byte string: patterns running into the terminal
            tail += [np.append(sx[n_real - k:n_real], ax.terminal_code)
                     .astype(np.uint8) for k in range(24)]
        case("terminal_tail", *search_rows(dev, tail, word))
        empty = torch.randint(0, total + 1, lo0.shape, device=cuda,
                              dtype=torch.int32)
        case("empty", pat, mask, lengths, empty, empty.clone())
        case("fetch=4", *rows_b, fetch=4)
        case("fetch=64", *rows_b, fetch=64)
        spw = dev.s_text.syms_per_word if word else 4
        for nw in (3, 16, 17, 32 if word else 128):
            pats = []
            for i in range(256):  # lengths that need all nw words
                m = int(frng.integers((nw - 1) * spw + 1, nw * spw + 1))
                if i % 2:
                    p0 = int(frng.integers(0, n_real - m))
                    pats.append(np.asarray(sx[p0:p0 + m]))
                else:
                    pats.append(frng.integers(0, len(ax.symbols), m)
                                .astype(np.uint8))
            case(f"nw={nw}", *search_rows(dev, pats, word, nw * spw))
        for b in (1, 33, 0):
            case(f"B={b}", *(x[:b] for x in rows_b))
        idx = torch.randint(0, pat.shape[0], (1 << 19,), device=cuda)
        large = tuple(x[idx].contiguous() for x in rows_b)
        case("2^20 lanes", *large)

        # the row: the find-and-fetch batch, and 2^20 lanes
        fused, plain, unfused = calls(*rows_b, FETCH)
        nbytes, n_ops, trips_max = work(*rows_b, FETCH)
        b_ms, b_by = bound(nbytes, n_ops)
        fl, pl, ul = calls(*large, FETCH)
        nbytes_l, n_ops_l, trips_l = work(*large, FETCH)
        bl_ms, bl_by = bound(nbytes_l, n_ops_l)
        # the longest lane's dependent round trips: its window and pattern
        # row, the first ell entry, one per trip, then the ell entry at the
        # lower bound and the text there
        lat = lambda trips: (trips + 4) * dram_rt_ms
        replaces = ("src/repro/kernels/probe_gather.py:80" if word
                    else "src/repro/kernels/pattern_probe.py:57")
        search = lambda: ops.search_bounds(
            dev.s_text, dev.ell, pat, mask, lengths, None, lo0, hi0,
            n_iter=dev.n_iter, bounds=2, word=word)
        # profiler device time per call (event windows of back-to-back
        # small launches hold the wrappers' host time)
        def per_call(fn):
            ms = device_ms(lambda: [fn() for _ in range(20)])
            return None if ms is None else ms / 20
        return {"name": kernel, "replaces": replaces,
                "replaces_composition": "src/repro/core/query.py:207",
                "shape": f"B={pat.shape[0]} lanes={2 * pat.shape[0]} "
                         f"nw={pat.shape[1]} fetch={FETCH}",
                "ms": cuda_ms(fused, inner=100),
                "plain_ms": cuda_ms(plain, inner=2),
                "unfused_ms": cuda_ms(unfused, inner=20),
                "search_ms": cuda_ms(search, inner=100),
                "device_ms": per_call(fused),
                "unfused_device_ms": per_call(unfused),
                "search_device_ms": per_call(search),
                "bound_ms": b_ms, "bound_by": b_by,
                "bound_note": "this run's trips' and epilogue's bytes over "
                              "3.35 TB/s; latency_bound_ms: the longest "
                              "lane's dependent round trips (trips + 4) "
                              "times the measured DRAM round trip",
                "latency_bound_ms": lat(trips_max), "trips_max": trips_max,
                "dram_round_trip_ms": dram_rt_ms,
                "large": {"shape": f"B={large[0].shape[0]} "
                                   f"lanes={2 * large[0].shape[0]} "
                                   f"nw={pat.shape[1]} fetch={FETCH}",
                          "ms": cuda_ms(fl, inner=5),
                          "plain_ms": cuda_ms(pl, reps=1),
                          "unfused_ms": cuda_ms(ul, inner=2),
                          "bound_ms": bl_ms, "bound_by": bl_by,
                          "latency_bound_ms": lat(trips_l),
                          "trips_max": trips_l}}

    def gather_call(kernel: str):
        return getattr(ops, kernel), getattr(kref, f"{kernel}_ref")

    def edge_offsets(f: int, hi: int) -> torch.Tensor:
        """int32[f] offsets in [0, hi], the last 64 at the end."""
        offs = torch.randint(0, hi + 1, (f,), device=cuda, dtype=torch.int32)
        k = min(f, 64)
        if k:
            offs[-k:] = torch.arange(hi - k + 1, hi + 1, device=cuda,
                                     dtype=torch.int32)
        return offs

    def gather_edges(kernel: str, text, hi: int, spw: int, name: str) -> None:
        """A redesigned gather against its plain version on every NW
        template and two nw outside them (as far as the text's read
        contract reaches), launches of GATHER_ROWS rows, offsets up to
        ``hi`` (the text's end), without a mask, with a mixed one and with
        every row masked off (exact)."""
        fn, plain = gather_call(kernel)
        # the dense texts' read contract: w up to their extra symbols
        limit = 2 * cfg.w_max + 8 if kernel != "range_gather_pack" else 1e9
        ws = [nw * spw for nw in GATHER_NW if nw * spw <= limit]
        cases = 0
        for w in ws:
            for f in GATHER_ROWS:
                offs = edge_offsets(f, hi)
                for mask in (None, torch.rand(f, device=cuda) < 0.5,
                             torch.zeros(f, dtype=torch.bool, device=cuda)):
                    assert_equal(fn(text, offs, w, mask=mask),
                                 plain(text, offs, w, mask),
                                 f"{kernel} {name} w={w} rows={f} "
                                 f"mask={None if mask is None else 'on'}")
                    cases += 1
        emit({"phase": "parity", "kernel": kernel, "text": name,
              "case": "edges", "w": ws, "rows": list(GATHER_ROWS),
              "masks": ["none", "mixed", "all off"], "cases": cases,
              "max_abs_err": 0})

    def gather_past_2_31(kernel: str, text, hi: int, w: int, nw: int,
                         name: str) -> None:
        """One launch with more than 2^31 output words (nw = 16 rows, as
        ``REPRO_COMPACT=off`` reaches at w = 256): the rows whose words lie
        past 2^31 against the plain version on those rows alone, a mixed
        mask on; the 8 GiB output is freed after."""
        fn, plain = gather_call(kernel)
        first = (1 << 31) // nw
        f = first + (1 << 20)
        offs = edge_offsets(f, hi)
        mask = offs % 7 != 0
        out = fn(text, offs, w, mask=mask)
        assert_equal(out[first:], plain(text, offs[first:], w, mask[first:]),
                     f"{kernel} {name} past 2^31 words")
        emit({"phase": "parity", "kernel": kernel, "text": name,
              "case": "past 2^31 words", "rows": f, "w": w,
              "words": f * nw, "rows_checked": f - first, "max_abs_err": 0})
        del out, offs, mask
        torch.cuda.empty_cache()

    def l2_window_row(fn, buf: torch.Tensor) -> dict:
        """The kernel's time without and under a persisting L2 window over
        its text (the measuring harness of ``gather_bench``; no kernel of
        the port sets one), in turns off, on, on, off."""
        off = [cuda_ms(fn)]
        with persisting_l2_window(buf) as ratio:
            on = [cuda_ms(fn), cuda_ms(fn)]
        off.append(cuda_ms(fn))
        return {"off_ms": float(np.median(off)), "on_ms": float(np.median(on)),
                "hit_ratio": ratio}

    def build_bounds(counts: dict, n_sym: int) -> dict:
        """Least ms of the port kernels a counted build launched, from its
        launches and the gathers' row and word tallies: a gather moves its
        offsets, mask bytes and keys (its scattered text reads, which can
        hit L2, left out), ``lcp_pairs`` both key rows and three outputs
        per row (its rows are the byte gather's: ``range_gather_pack`` on
        a byte string, ``range_gather_packed`` in the byte leg),
        ``kmer_histogram`` the string once per launch."""
        b = {k: ((5 * counts[f"{k}_rows"] + 4 * counts[f"{k}_words"])
                 / HBM_BYTES_PER_S * 1e3) for k in GATHERS}
        byte = ("range_gather_pack", "range_gather_packed")
        b["lcp_pairs"] = ((8 * sum(counts[f"{k}_words"] for k in byte)
                           + 12 * sum(counts[f"{k}_rows"] for k in byte))
                          / HBM_BYTES_PER_S * 1e3)
        b["kmer_histogram"] = (counts["kmer_histogram"] * n_sym
                               / HBM_BYTES_PER_S * 1e3)
        return b

    def build_profile(name: str, sx: np.ndarray, ax, t_prepare_s: float,
                      counts: dict) -> dict:
        """One more warm ``build_device`` of ``name`` (the counted build's
        tallies and seconds stay as they were) under ``torch.profiler``:
        device ms and calls per kernel name, the two gathers' ms and
        their share of the counted build's ``t_prepare_s``, the device's
        busy share of the build's wall, and each port kernel's ms beside
        its bound for the counted build's work (``counts``).  CUDA events
        around each launch of the build's port kernels give the same ms
        where the profiler records none for a kernel loaded with ctypes."""
        from torch.profiler import ProfilerActivity, profile
        events = {k: [] for k in BUILD_KERNELS[name]}
        saved = {k: getattr(ops, k) for k in events}

        def timed(kname, fn):
            def call(*a, **kw):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*a, **kw)
                e1.record()
                events[kname].append((e0, e1))
                return out
            return call

        torch.cuda.synchronize()
        report = BuildReport(VerticalStats(), PrepareStats())
        try:
            for k, fn in saved.items():
                setattr(ops, k, timed(k, fn))
            # device activity only: recording every host op of a build
            # costs minutes of post-processing
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                dev = EraIndexer(ax, cfg).build_device(sx, report)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            for k, fn in saved.items():
                setattr(ops, k, fn)
        del dev
        torch.cuda.empty_cache()
        brk = device_breakdown(prof, wall, top=None)
        per = {k: {"ms": 0.0, "calls": 0} for k in events}
        for r in brk["top_kernels"]:
            if r["kernel"] in per:
                per[r["kernel"]]["ms"] += r["ms"]
                per[r["kernel"]]["calls"] += r["calls"]
        bounds = build_bounds(counts, len(sx))
        for k, evs in events.items():
            per[k]["event_ms"] = sum(a.elapsed_time(b) for a, b in evs)
            per[k]["launches"] = len(evs)
            per[k]["ms_in_build"] = (per[k]["ms"] if per[k]["calls"]
                                     else per[k]["event_ms"])
            per[k]["source"] = "profiler" if per[k]["calls"] else "events"
            per[k]["bound_ms"] = bounds[k]
            per[k]["excess_ms"] = per[k]["ms_in_build"] - bounds[k]
        gathers = sum(v["ms_in_build"] for k, v in per.items()
                      if k in GATHERS)
        row = {"phase": "build_profile", "dataset": name, "n": len(sx) - 1,
               "t_total_s": wall, "t_prepare_s": report.t_prepare,
               "counted_t_prepare_s": t_prepare_s,
               "device_ms": brk["device_ms"],
               "device_busy_share": brk["device_busy_share"],
               "port_kernels": per, "gathers_ms": gathers,
               "gathers_share_of_t_prepare": gathers / (t_prepare_s * 1e3),
               "kernels": brk["top_kernels"]}
        emit(row)
        return row

    kmer_rows: dict = {}  # (dataset, k) -> the kernel's ms, path, yardstick
    lcp_w256: dict = {}  # text -> suffix_lcp_words ms at w = 256, by chain

    def lcp_word_cases(name: str, ptx, offs: torch.Tensor) -> None:
        """``suffix_lcp_words`` against its plain version on neighbour
        pairs in the order of their 64-symbol keys (long shared prefixes;
        ``pos_a[i + 1] == pos_b[i]`` on every row, as adjacent leaves),
        the same pairs with 30 % of the chain cut and in a random order
        (no adjacency), each with pairs at ``n_real - 1`` and ``n_real``;
        at w = 4, 64, 128, 256 and at every NW bucket and two widths
        outside them that the text's padding allows.  Timed at w = 4, 64
        and 256 on the chained pairs, at 256 also unchained."""
        nr, spw = ptx.n_real, ptx.syms_per_word
        pa, pb = sorted_pairs(ops.range_gather_words(ptx, offs, 64), offs)
        end_a = torch.tensor([nr - 1, nr, nr - 1, nr, 0], dtype=torch.int32,
                             device=cuda)
        end_b = torch.tensor([nr, nr - 1, nr - 2, 0, nr], dtype=torch.int32,
                             device=cuda)
        cut = torch.rand(pa.shape[0], device=cuda) < 0.3
        perm = torch.randperm(pa.shape[0], device=cuda)
        chains = {"full": (pa, pb),
                  "partial": (torch.where(cut, pa.flip(0), pa), pb),
                  "none": (pa[perm], pb[perm])}
        chains = {c: (torch.cat([a, end_a]).contiguous(),
                      torch.cat([b_, end_b]).contiguous())
                  for c, (a, b_) in chains.items()}
        room = (ptx.words.shape[0] - 1) * spw - nr  # symbols past n_real
        widths = sorted({4, 64, 128, 256} | {
            nw * spw for nw in (1, 2, 3, 4, 8, 16, 24, 32, 64)
            if nw * spw + spw <= room})
        for chain, (a, b_) in chains.items():
            share = float((a[1:] == b_[:-1]).float().mean())
            for w in widths:
                got = ops.suffix_lcp_words(ptx, a, b_, w)
                assert_equal(got, kref.suffix_lcp_words_ref(ptx, a, b_, w),
                             f"suffix_lcp_words {name} {chain} w={w}")
                if not ((chain == "full" and w in (4, 64, 256))
                        or (chain == "none" and w == 256)):
                    continue
                b_ms, b_by = bound(*suffix_lcp_work(
                    got, w, spw, ptx.nbytes, 8))
                row = {"ms": cuda_ms(lambda: ops.suffix_lcp_words(
                    ptx, a, b_, w))}
                if w == 256:
                    lcp_w256.setdefault(name, {})[chain] = row["ms"]
                emit({"phase": "parity", "kernel": "suffix_lcp_words",
                      "text": name, "bits": ptx.bits, "rows": a.shape[0],
                      "w": w, "chain": chain, "adjacent_share": share,
                      "max_abs_err": 0,
                      "saturated_rows": int((got == w).sum()), **row,
                      "plain_ms": cuda_ms(
                          lambda: kref.suffix_lcp_words_ref(ptx, a, b_, w)),
                      "bound_ms": b_ms, "bound_by": b_by})
            emit({"phase": "parity", "kernel": "suffix_lcp_words",
                  "text": name, "bits": ptx.bits, "chain": chain,
                  "adjacent_share": share, "rows": a.shape[0],
                  "widths_checked": widths, "max_abs_err": 0})

    def kmer_parity(name: str, sp: torch.Tensor, n_win: int, k: int,
                    base: int) -> None:
        """``kmer_histogram`` against its plain version on the whole
        string (timed, beside ``torch.bincount`` of the precomputed codes:
        a yardstick for the counting step alone) and on its edge cases: a
        start off every 16-byte boundary, one window, ragged tails, a
        homopolymer and a densely planted 64-symbol motif."""
        got = ops.kmer_histogram(sp, n_win, k, base)
        path = ops.kmer_histogram.last_path
        assert_equal(got, kref.kmer_histogram_ref(sp, n_win, k, base),
                     f"kmer_histogram {name} k={k}")
        assert int(got.sum()) == n_win
        m = 1 << 20
        head = sp[:m + 64]
        motif = head[:64].clone()
        planted = head.clone()
        for o in range(0, m, 640):
            planted[o:o + 64] = motif
        homo = torch.full_like(head, int(head[0]))
        cases = [(f"offset {o}", head[o:], m - 15) for o in range(1, 16)]
        cases += [(f"ragged {r}", head, r) for r in (1, 15, 31, 33, 4097)]
        cases += [("homopolymer", homo, m), ("motif", planted, m)]
        for case, text, nc in cases:
            assert_equal(ops.kmer_histogram(text, nc, k, base),
                         kref.kmer_histogram_ref(text, nc, k, base),
                         f"kmer_histogram {name} k={k} {case}")
        codes = torch.zeros(n_win, dtype=torch.int64, device=cuda)
        for d in range(k):
            codes = codes * base + sp[d:d + n_win].to(torch.int64)
        bincount_ms = cuda_ms(lambda: torch.bincount(codes,
                                                     minlength=base**k))
        del codes
        b_ms, b_by = bound(*kmer_work(n_win, k, base))
        row = {"ms": cuda_ms(lambda: ops.kmer_histogram(sp, n_win, k, base)),
               "last_path": path, "bincount_ms": bincount_ms}
        kmer_rows[(name, k)] = row
        emit({"phase": "parity", "kernel": "kmer_histogram", "text": name,
              "n": n_win, "k": k, "bins": base**k, "max_abs_err": 0,
              "edge_cases": len(cases), **row,
              "plain_ms": cuda_ms(lambda: kref.kmer_histogram_ref(
                  sp, n_win, k, base)),
              "bound_ms": b_ms, "bound_by": b_by})

    # ---- 1. device --------------------------------------------------------
    smi = nvidia_smi()
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # the earlier designs' nvcc runs beside the port's
        yard_future = pool.submit(lambda: {
            **gather_bench.build_baseline(YARDSTICK_DIR),
            **hist_lcp_bench.build_baseline(YARDSTICK_DIR)})
        compile_s = _build.build_all()
        yard = yard_future.result()
    t_build_kernels = time.perf_counter() - t0
    for name in _build.SOURCES:  # load every library once
        _build.library(name)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernel_build_s": t_build_kernels,
          "nvcc_s": compile_s, "build_dir": str(_build.build_dir()),
          "yardsticks": sorted(yard)})
    for name in _build.SOURCES:  # registers / spills from -Xptxas -v
        log = (_build.build_dir() / f"{name}.log")
        if log.exists():
            lines = [l.strip() for l in log.read_text().splitlines()
                     if "registers" in l or "spill" in l]
            emit({"phase": "ptxas", "kernel": name, "report": lines})
    dram_rt_ms = dram_round_trip_ms()
    emit({"phase": "dram_round_trip", "ms": dram_rt_ms,
          "note": "one thread's dependent __ldcg walk of a random cycle over "
                  "1 GiB, no line visited twice (csrc/dram_latency.cu), ms "
                  "per hop"})

    # ---- data -------------------------------------------------------------
    n = 1 << args.n_log2
    t0 = time.perf_counter()
    s, alpha = dataset("genome", n, seed=0)
    emit({"phase": "data", "dataset": "genome", "n": n,
          "t_generate_s": time.perf_counter() - t0})
    cfg = EraConfig()
    pt = packing.pack_text(s, alpha, extra=2 * cfg.w_max + 8, device=cuda)
    n_real = pt.n_real
    rng = np.random.default_rng(7)

    # ---- 2. kernel parity (exact) -----------------------------------------
    f = 1 << 20
    tail = np.arange(max(0, n_real - 255), n_real + 1)
    offs_np = np.concatenate([rng.integers(0, n_real + 1, size=f - tail.size),
                              tail]).astype(np.int32)
    offs = torch.from_numpy(offs_np).to(cuda)
    for w in (4, 8, 16, 32, 64, 128, 256):
        got = ops.range_gather_words(pt, offs, w)
        want = kref.range_gather_words_ref(pt, offs, w)
        assert_equal(got, want, f"range_gather_words w={w}")
        nw = got.shape[1]
        b_ms, b_by = bound(*gather_work(f, nw, pt.words.shape[0]))
        emit({"phase": "parity", "kernel": "range_gather_words", "rows": f,
              "w": w, "max_abs_err": 0,
              "ms": cuda_ms(lambda: ops.range_gather_words(pt, offs, w)),
              "plain_ms": cuda_ms(
                  lambda: kref.range_gather_words_ref(pt, offs, w)),
              "bound_ms": b_ms, "bound_by": b_by})
    gather_edges("range_gather_words", pt, n_real, pt.syms_per_word, "genome")
    gather_past_2_31("range_gather_words", pt, n_real,
                     16 * pt.syms_per_word, 16, "genome")

    b = 512
    m_pad = 64
    lengths_np = rng.integers(4, m_pad + 1, size=b).astype(np.int32)
    pos_np = rng.integers(0, n_real + 1, size=b).astype(np.int32)
    pos_np[-32:] = rng.integers(max(0, n_real - m_pad), n_real + 1, size=32)
    sym = rng.integers(0, len(alpha.symbols), size=(b, m_pad)).astype(np.int32)
    for i in range(0, b, 2):  # plant the suffix itself: verdict 0 or ±1 at $
        p = int(pos_np[i])
        seg = s[p:min(p + m_pad, n_real)]
        sym[i, :seg.size] = seg
    patterns = torch.from_numpy(sym).to(cuda)
    lengths = torch.from_numpy(lengths_np).to(cuda)
    pos = torch.from_numpy(pos_np).to(cuda)
    pat_d, mask_d = _pack_query_batch(pt, patterns, lengths)
    got = ops.pattern_probe_words(pt, pos, pat_d, mask_d, lengths)
    want = kref.pattern_probe_words_ref(pt, pos, pat_d, mask_d, lengths)
    assert_equal(got, want, "pattern_probe_words")
    b_ms, b_by = bound(*probe_work(b, pat_d.shape[1], pt.words.shape[0]))
    emit({"phase": "parity", "kernel": "pattern_probe_words", "rows": b,
          "m_pad": m_pad, "max_abs_err": 0,
          "verdicts": {str(v): int((got == v).sum()) for v in (-1, 0, 1)},
          "ms": cuda_ms(lambda: ops.pattern_probe_words(
              pt, pos, pat_d, mask_d, lengths), inner=100),
          "plain_ms": cuda_ms(lambda: kref.pattern_probe_words_ref(
              pt, pos, pat_d, mask_d, lengths), inner=20),
          "bound_ms": b_ms, "bound_by": b_by})

    # pattern_probe_packed: byte-key rows over the DNA dense text, patterns
    # cut from the terminal-padded string so they carry the terminal code
    sp_dna = alpha.pad_string(s, extra=m_pad)
    sym_t = rng.integers(0, alpha.base, size=(b, m_pad)).astype(np.int32)
    for i in range(0, b, 2):
        sym_t[i] = sp_dna[pos_np[i]:pos_np[i] + m_pad]
    pat_b, mask_b = _pack_query_batch(
        None, torch.from_numpy(sym_t).to(cuda), lengths, word=False)
    got = ops.pattern_probe_packed(pt, pos, pat_b, mask_b)
    want = kref.pattern_probe_packed_ref(pt, pos, pat_b, mask_b)
    assert_equal(got, want, "pattern_probe_packed")
    nw_dense = -(-m_pad // pt.syms_per_word)
    b_ms, b_by = bound(*probe_work(b, nw_dense, pt.words.shape[0]))
    emit({"phase": "parity", "kernel": "pattern_probe_packed", "rows": b,
          "m_pad": m_pad, "max_abs_err": 0,
          "terminal_rows": int((sym_t == alpha.terminal_code).any(1).sum()),
          "verdicts": {str(v): int((got == v).sum()) for v in (-1, 0, 1)},
          "ms": cuda_ms(lambda: ops.pattern_probe_packed(
              pt, pos, pat_b, mask_b), inner=100),
          "plain_ms": cuda_ms(lambda: kref.pattern_probe_packed_ref(
              pt, pos, pat_b, mask_b), inner=20),
          "bound_ms": b_ms, "bound_by": b_by})
    del sp_dna
    fused_parity("genome", pt, s, alpha)

    s_pad = torch.from_numpy(np.concatenate(
        [s, np.full(8, alpha.terminal_code, np.uint8)])).to(cuda)
    n_win = len(s)
    for k in range(1, 7):
        kmer_parity("genome", s_pad, n_win, k, alpha.base)
    del offs, got, want, pat_d, mask_d, pat_b, mask_b
    torch.cuda.empty_cache()

    # range_gather_packed and suffix_lcp_words on the DNA (2-bit) build
    # text and a PROTEIN_CLASS (4-bit) text; the LCP pairs are neighbours
    # in the order of their 64-symbol keys (long shared prefixes), and
    # the offsets include the last n_real positions
    pc_alpha = ALPHABETS["protein_class"]
    dense_texts = {"genome": pt, "protein_class": packing.pack_text(
        synthetic_string(pc_alpha, n, seed=0, repeat_fraction=0.15),
        pc_alpha, extra=2 * cfg.w_max + 8, device=cuda),
        "byte": packing.pack_text(
            synthetic_string(ALPHABETS["byte"], min(n, 1 << 24), seed=0,
                             repeat_fraction=0.10),
            ALPHABETS["byte"], extra=2 * cfg.w_max + 8, device=cuda)}
    for name, ptx in dense_texts.items():
        nr = ptx.n_real
        # every BITS x NW template, offsets at and past n_real
        gather_edges("range_gather_packed", ptx, nr + 32, 4, name)
        if name == "genome":
            gather_past_2_31("range_gather_packed", ptx, nr, 64, 16, name)
        if name == "byte":  # the 8-bit words: suffix_lcp_words' bits 8 only
            lcp_word_cases(name, ptx, torch.from_numpy(np.concatenate(
                [rng.integers(0, nr + 1, size=f - 256),
                 np.arange(nr - 255, nr + 1)]).astype(np.int32)).to(cuda))
            continue
        if name == "protein_class":
            gather_edges("range_gather_words", ptx, nr, ptx.syms_per_word,
                         name)
        tail = np.arange(max(0, nr - 255), nr + 1)
        offs = torch.from_numpy(np.concatenate(
            [rng.integers(0, nr + 1, size=f - tail.size), tail]
        ).astype(np.int32)).to(cuda)
        for w in (4, 16, 64, 256):
            got = ops.range_gather_packed(ptx, offs, w)
            want = kref.range_gather_packed_ref(ptx, offs, w)
            assert_equal(got, want, f"range_gather_packed {name} w={w}")
            b_ms, b_by = bound(*gather_packed_work(f, w // 4, ptx.bits,
                                                   ptx.words.shape[0]))
            emit({"phase": "parity", "kernel": "range_gather_packed",
                  "text": name, "bits": ptx.bits, "rows": f, "w": w,
                  "max_abs_err": 0,
                  "ms": cuda_ms(lambda: ops.range_gather_packed(ptx, offs, w)),
                  "plain_ms": cuda_ms(
                      lambda: kref.range_gather_packed_ref(ptx, offs, w)),
                  "bound_ms": b_ms, "bound_by": b_by})
        lcp_word_cases(name, ptx, offs)
    del dense_texts, ptx, offs, got, want
    torch.cuda.empty_cache()

    # byte-key kernels over the protein text (the build's padding) and a
    # BYTE-alphabet text (codes up to 255: hazard C5)
    t0 = time.perf_counter()
    s_prot, protein = dataset("protein", n, seed=0)
    n_byte = min(n, 1 << 24)
    s_byte, byte_alpha = dataset("byte", n_byte, seed=0)
    emit({"phase": "data", "dataset": "protein", "n": n,
          "byte_parity_n": n_byte, "t_generate_s": time.perf_counter() - t0})
    texts = {}
    for name, (sx, ax) in {"protein": (s_prot, protein),
                           "byte": (s_byte, byte_alpha)}.items():
        texts[name] = (sx, ax, torch.from_numpy(
            ax.pad_string(sx, extra=2 * cfg.w_max + 8)).to(cuda))
    for name, (sx, ax, sp) in texts.items():  # the partition's counts
        for k in range(1, 4 if name == "protein" else 3):
            kmer_parity(name, sp, len(sx), k, ax.base)
    for name, (sx, ax, sp) in texts.items():
        nr = len(sx) - 1
        tail = np.concatenate([np.arange(nr - 255, nr + 1),
                               np.arange(nr + 1, sp.shape[0], 61)])
        offs = torch.from_numpy(np.concatenate(
            [rng.integers(0, nr + 1, size=f - tail.size), tail]
        ).astype(np.int32)).to(cuda)
        for w in (4, 8, 16, 32, 64, 128, 256):
            got = ops.range_gather_pack(sp, offs, w)
            want = kref.range_gather_pack_ref(sp, offs, w)
            assert_equal(got, want, f"range_gather_pack {name} w={w}")
            b_ms, b_by = bound(*gather_pack_work(f, w // 4, sp.shape[0]))
            emit({"phase": "parity", "kernel": "range_gather_pack",
                  "text": name, "rows": f, "w": w, "max_abs_err": 0,
                  "ms": cuda_ms(lambda: ops.range_gather_pack(sp, offs, w)),
                  "plain_ms": cuda_ms(
                      lambda: kref.range_gather_pack_ref(sp, offs, w)),
                  "bound_ms": b_ms, "bound_by": b_by})
        del got, want
        gather_edges("range_gather_pack", sp, sp.shape[0] - 1, 4, name)
        if name == "protein":
            gather_past_2_31("range_gather_pack", sp, sp.shape[0] - 1, 64, 16,
                             name)

    pt_byte = packing.pack_text(s_byte, byte_alpha, extra=2 * cfg.w_max + 8,
                                device=cuda)
    gather_edges("range_gather_words", pt_byte, pt_byte.n_real,
                 pt_byte.syms_per_word, "byte")
    fused_parity("byte", pt_byte, s_byte, byte_alpha)
    del pt_byte

    # lcp_pairs on sorted byte-key rows: a repeated eighth of the offsets
    # gives identical neighbours, the byte text bytes >= 128
    sx, ax, sp = texts["byte"]
    base_offs = rng.integers(0, len(sx), size=f - f // 8)
    offs = torch.from_numpy(np.concatenate(
        [base_offs, base_offs[:f // 8]]).astype(np.int32)).to(cuda)
    for w in (4, 8, 16, 32, 64, 128, 256):
        keys = ops.range_gather_pack(sp, offs, w)
        nw = keys.shape[1]
        order = _stable_order(_pair_lanes(
            [packing.to_u64(keys[None, :, j]) for j in range(nw)]))[0]
        keys = keys[order].contiguous()
        prev = torch.cat([keys[:1], keys[:-1]]).contiguous()
        got = ops.lcp_pairs(prev, keys, w)
        want = kref.lcp_pairs_ref(prev, keys, w)
        for g, x, part in zip(got, want, ("lcp", "c1", "c2")):
            assert_equal(g, x, f"lcp_pairs {part} w={w}")
        b_ms, b_by = bound(*lcp_work(f, nw))
        emit({"phase": "parity", "kernel": "lcp_pairs", "rows": f, "w": w,
              "max_abs_err": 0, "equal_rows": int((got[0] == w).sum()),
              "high_byte_rows": int(((got[1] >= 128) | (got[2] >= 128)).sum()),
              "ms": cuda_ms(lambda: ops.lcp_pairs(prev, keys, w)),
              "plain_ms": cuda_ms(lambda: kref.lcp_pairs_ref(prev, keys, w)),
              "bound_ms": b_ms, "bound_by": b_by})
    del keys, prev, got, want, order

    # pattern_probe: 512 rows of lengths 4-64 on each text, suffixes
    # running into the terminal
    for name, (sx, ax, sp) in texts.items():
        nr = len(sx) - 1
        sp_np = ax.pad_string(sx, extra=m_pad)
        pos_np = rng.integers(0, nr + 1, size=b).astype(np.int32)
        pos_np[-32:] = rng.integers(max(0, nr - m_pad), nr + 1, size=32)
        sym = rng.integers(0, len(ax.symbols), size=(b, m_pad)).astype(np.int32)
        for i in range(0, b, 2):
            sym[i] = sp_np[pos_np[i]:pos_np[i] + m_pad]
        pos = torch.from_numpy(pos_np).to(cuda)
        pat_b, mask_b = _pack_query_batch(
            None, torch.from_numpy(sym).to(cuda), lengths, word=False)
        got = ops.pattern_probe(sp, pos, pat_b, mask_b)
        want = kref.pattern_probe_ref(sp, pos, pat_b, mask_b)
        assert_equal(got, want, f"pattern_probe {name}")
        b_ms, b_by = bound(*probe_bytes_work(b, m_pad // 4, sp.shape[0]))
        emit({"phase": "parity", "kernel": "pattern_probe", "text": name,
              "rows": b, "m_pad": m_pad, "max_abs_err": 0,
              "verdicts": {str(v): int((got == v).sum()) for v in (-1, 0, 1)},
              "ms": cuda_ms(lambda: ops.pattern_probe(sp, pos, pat_b, mask_b),
                            inner=100),
              "plain_ms": cuda_ms(lambda: kref.pattern_probe_ref(
                  sp, pos, pat_b, mask_b), inner=20),
              "bound_ms": b_ms, "bound_by": b_by})
    # suffix_lcp_pairs on the protein text and the byte text (codes >=
    # 128), neighbour pairs in key order and the last positions
    slcp = ops.KERNELS["suffix_lcp_pairs"]
    for name, (sx, ax, sp) in texts.items():
        nr = len(sx) - 1
        tail = np.arange(nr - 255, nr + 1)
        offs = torch.from_numpy(np.concatenate(
            [rng.integers(0, nr + 1, size=f - tail.size), tail]
        ).astype(np.int32)).to(cuda)
        pa, pb = sorted_pairs(ops.range_gather_pack(sp, offs, 64), offs)
        for w in (4, 64, 256):
            got = slcp(sp, pa, pb, w)
            want = kref.suffix_lcp_pairs_ref(sp, pa, pb, w)
            assert_equal(got, want, f"suffix_lcp_pairs {name} w={w}")
            b_ms, b_by = bound(*suffix_lcp_work(got, w, 4, sp.shape[0], 8))
            emit({"phase": "parity", "kernel": "suffix_lcp_pairs",
                  "text": name, "rows": pa.shape[0], "w": w,
                  "max_abs_err": 0, "saturated_rows": int((got == w).sum()),
                  "ms": cuda_ms(lambda: slcp(sp, pa, pb, w)),
                  "plain_ms": cuda_ms(
                      lambda: kref.suffix_lcp_pairs_ref(sp, pa, pb, w)),
                  "bound_ms": b_ms, "bound_by": b_by})
    del pa, pb
    del texts, offs, got, want, pat_b, mask_b, s_byte, sp
    torch.cuda.empty_cache()

    # ---- 3-5. the DNA path (build, check, serving; counted) ----------------
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    report = BuildReport(VerticalStats(), PrepareStats())
    t0 = time.perf_counter()
    dev = EraIndexer(alpha, cfg).build_device(s, report)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    after_build = counts_now()
    emit({"phase": "build", "dataset": "genome", "n": n,
          "memory_bytes": cfg.memory_bytes, "f_max": cfg.f_max,
          "t_total_s": t_build, "t_vertical_s": report.t_vertical,
          "t_prepare_s": report.t_prepare,
          "scans": report.vertical.scans,
          "iterations": report.prepare.iterations,
          "ranges": report.prepare.ranges,
          "active_history": report.prepare.active_history,
          "groups": report.n_groups, "prefixes": report.n_prefixes,
          "capacity": report.capacity, "n_subtrees": dev.n_subtrees,
          "k_route": dev.k_route, "n_iter": dev.n_iter,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": after_build})
    t_prepare, build_counts = {"genome": report.t_prepare}, after_build
    s_dev = torch.from_numpy(s).to(cuda)
    qrng = np.random.default_rng(11)
    pats = make_workload(s, qrng, batch=64, min_len=4, max_len=24,
                         planted_frac=0.7, n_symbols=len(alpha.symbols))
    emit({"phase": "check", "dataset": "genome",
          **check_index(dev, s, s_dev, pats, "genome"),
          "launches": counts_now()})
    stats = serve_index(dev, s, alpha, np.random.default_rng(1),
                        batch=256, iters=20, min_len=4, max_len=24,
                        planted_frac=0.7)
    dna_counts = counts_now()
    emit({"phase": "serving", "dataset": "genome", **stats,
          "launches": dna_counts})
    require_launches(dna_counts, DNA_KERNELS, "the DNA path")
    for name in ("range_gather_words", "kmer_histogram"):
        if after_build[name] <= 0:
            raise AssertionError(f"{name} was never launched by the build")
    if dna_counts["search_bounds_words"] <= after_build["search_bounds_words"]:
        raise AssertionError("the search never launched search_bounds_words")
    if dna_counts["pattern_probe_words"]:
        raise AssertionError("the DNA path launched the single-step probe")
    search_batch_launches(lambda: dev.find_batch_ranges(
        *dev.pad_batch(pats)), "search_bounds_words", "genome find_batch")

    # ---- 4b. the DNA terminal-bearing batch (counted) ----------------------
    term = alpha.terminal_code
    tpats = [np.asarray(s[len(s) - k:]) for k in (1, 2, 3, 5, 9, 17, 24)]
    tpats += [np.array([c, term], np.uint8) for c in range(term)]
    tpats += make_workload(s, qrng, batch=8, min_len=4, max_len=24,
                           planted_frac=0.7, n_symbols=len(alpha.symbols))
    ops.reset_launch_counts()
    term_check = check_index(dev, s, s_dev, tpats, "genome terminal batch")
    term_counts = counts_now()
    emit({"phase": "check", "dataset": "genome", "batch": "terminal-bearing",
          **term_check, "launches": term_counts})
    require_launches(term_counts, TERMINAL_KERNELS, "the terminal batch")
    if (term_counts["pattern_probe_words"]
            or term_counts["search_bounds_words"]):
        raise AssertionError("a terminal-bearing batch took the word probe")

    # ---- 5b. find-and-fetch and the serving stack on the DNA index ---------
    frng = np.random.default_rng(17)
    ff_pats = make_workload(s, frng, batch=256, min_len=4, max_len=24,
                            planted_frac=0.7, n_symbols=len(alpha.symbols))
    ff_check, ff_counts = check_find_fetch(dev, s_dev, ff_pats,
                                           "genome find_fetch")
    emit({"phase": "find_fetch", "dataset": "genome", **ff_check,
          "launches": ff_counts})
    require_fetch(ff_counts, "genome", "the genome find-and-fetch path")
    emit({"phase": "find_fetch_latency", "dataset": "genome",
          "batch": len(ff_pats), **fetch_latency(dev, ff_pats)})
    ff_check, tff_counts = check_find_fetch(dev, s_dev, tpats,
                                            "genome terminal fetch")
    emit({"phase": "find_fetch", "dataset": "genome",
          "batch": "terminal-bearing", **ff_check, "launches": tff_counts})
    require_fetch(tff_counts, "terminal", "the terminal-bearing fetch")
    dna_serve_counts = serving_stack(dev, s, alpha, "genome")
    require_fetch(dna_serve_counts[FETCH], "genome",
                  "the genome serving stack")

    # the fused kernels at the find-and-fetch shape (a served batch of 256,
    # fetch 32, at each pattern's lower-bound suffix) and at 2^20 rows
    fetch_rows = []
    big = 1 << 20
    for kind, pats_b, replaces in (
            ("words", ff_pats, "src/repro/kernels/probe_gather.py:80"),
            ("packed", (tpats * 14)[:256],
             "src/repro/kernels/probe_gather.py:174")):
        padded, lens, route = dev.pad_batch(pats_b)
        lens_t = torch.from_numpy(lens).to(cuda)
        start, _ = dev.find_batch_ranges(padded, lens, route)
        pos0 = dev.ell[torch.clamp(start, 0, dev.n_leaves - 1)]
        pat, mask = _pack_query_batch(dev.s_text,
                                      torch.from_numpy(padded).to(cuda),
                                      lens_t, kind == "words")
        row = fused_case(kind, dev.s_text, pos0, pat, mask, lens_t, FETCH,
                         inner=100)
        reps = big // pos0.shape[0]
        pos_l = dev.ell[torch.randint(0, dev.n_leaves, (big,), device=cuda)]
        large = fused_case(kind, dev.s_text, pos_l, pat.repeat(reps, 1),
                           mask.repeat(reps, 1), lens_t.repeat(reps), FETCH,
                           inner=1)
        shape = lambda r: (f"rows={r['rows']} nw_pat={r['nw_pat']} "
                           f"fetch={FETCH}")
        fetch_rows.append({
            "name": f"probe_gather_{kind}", "replaces": replaces,
            "shape": shape(row), "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "two_launch_ms": row["two_launch_ms"],
            "large": {"shape": shape(large), **{
                k: large[k] for k in ("ms", "plain_ms", "two_launch_ms",
                                      "bound_ms", "bound_by")}}})
    del pos0, pos_l, pat, mask, lens_t

    # ---- 6a. DNA kernels at the main path's shapes -------------------------
    rows = []
    # range_gather_words: the first elastic step reads w = 4 symbols after
    # every suffix; ell holds all n + 1 of them, in suffix-array order
    ell = dev.ell
    got = ops.range_gather_words(pt, ell, 4)
    want = kref.range_gather_words_ref(pt, ell, 4)
    assert_equal(got, want, "range_gather_words (main-path shape)")
    b_ms, b_by = bound(*gather_work(ell.shape[0], got.shape[1],
                                    pt.words.shape[0]))
    ell_sorted = torch.sort(ell).values
    rows.append({"name": "range_gather_words",
                 "replaces": "src/repro/kernels/packed_gather.py:265",
                 "shape": f"rows={ell.shape[0]} w=4", "rows": ell.shape[0],
                 "ms": cuda_ms(lambda: ops.range_gather_words(pt, ell, 4)),
                 "plain_ms": cuda_ms(
                     lambda: kref.range_gather_words_ref(pt, ell, 4), reps=3),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "sorted_offsets_ms": cuda_ms(
                     lambda: ops.range_gather_words(pt, ell_sorted, 4)),
                 "l2_window": l2_window_row(
                     lambda: ops.range_gather_words(pt, ell, 4), pt.words)})
    del got, want, ell_sorted
    # pattern_probe_words: one search step of a served batch (2B rows)
    pats = make_workload(s, qrng, batch=256, min_len=4, max_len=24,
                         planted_frac=0.7, n_symbols=len(alpha.symbols))
    padded, lens, _ = dev.pad_batch(pats)
    padded_t = torch.from_numpy(padded).to(cuda)
    lens_t = torch.from_numpy(lens).to(cuda)
    pat_w, mask_w = _pack_query_batch(dev.s_text, padded_t, lens_t)
    pat2 = torch.cat([pat_w, pat_w])
    mask2 = torch.cat([mask_w, mask_w])
    len2 = torch.cat([lens_t, lens_t])
    pos2 = ell[torch.randint(0, ell.shape[0], (pat2.shape[0],), device=cuda)]
    got = ops.pattern_probe_words(dev.s_text, pos2, pat2, mask2, len2)
    want = kref.pattern_probe_words_ref(dev.s_text, pos2, pat2, mask2, len2)
    assert_equal(got, want, "pattern_probe_words (main-path shape)")
    b_ms, b_by = bound(*probe_work(pat2.shape[0], pat2.shape[1],
                                   dev.s_text.words.shape[0]))
    rows.append({"name": "pattern_probe_words",
                 "replaces": "src/repro/kernels/packed_gather.py:335",
                 "shape": f"rows={pat2.shape[0]} nw={pat2.shape[1]}",
                 "ms": cuda_ms(lambda: ops.pattern_probe_words(
                     dev.s_text, pos2, pat2, mask2, len2), inner=100),
                 "plain_ms": cuda_ms(lambda: kref.pattern_probe_words_ref(
                     dev.s_text, pos2, pat2, mask2, len2), inner=20),
                 "bound_ms": b_ms, "bound_by": b_by})
    # pattern_probe_packed: one search step of a served terminal-bearing
    # batch (2B rows of byte keys over the served dense text)
    tpats = (tpats * (256 // len(tpats) + 1))[:256]
    padded, lens, _ = dev.pad_batch(tpats)
    pat_b, mask_b = _pack_query_batch(
        None, torch.from_numpy(padded).to(cuda),
        torch.from_numpy(lens).to(cuda), word=False)
    pat2 = torch.cat([pat_b, pat_b])
    mask2 = torch.cat([mask_b, mask_b])
    got = ops.pattern_probe_packed(dev.s_text, pos2, pat2, mask2)
    want = kref.pattern_probe_packed_ref(dev.s_text, pos2, pat2, mask2)
    assert_equal(got, want, "pattern_probe_packed (main-path shape)")
    b_ms, b_by = bound(*probe_work(
        pat2.shape[0], -(-pat2.shape[1] * 4 // dev.s_text.syms_per_word),
        dev.s_text.words.shape[0]))
    rows.append({"name": "pattern_probe_packed",
                 "replaces": "src/repro/kernels/packed_gather.py:159",
                 "shape": f"rows={pat2.shape[0]} nw={pat2.shape[1]}",
                 "ms": cuda_ms(lambda: ops.pattern_probe_packed(
                     dev.s_text, pos2, pat2, mask2), inner=100),
                 "plain_ms": cuda_ms(lambda: kref.pattern_probe_packed_ref(
                     dev.s_text, pos2, pat2, mask2), inner=20),
                 "bound_ms": b_ms, "bound_by": b_by})
    rows.append(search_parity("words", dev, s, alpha, "genome"))
    rows.append(fetch_parity("words", dev, s, alpha, "genome"))
    # kmer_histogram: the deepest kernel-counted DNA partition scan (t = 6)
    k = 6
    b_ms, b_by = bound(*kmer_work(n_win, k, alpha.base))
    rows.append({"name": "kmer_histogram",
                 "replaces": "src/repro/kernels/kmer_histogram.py:46",
                 "shape": f"n={n_win} k={k}",
                 "ms": cuda_ms(lambda: ops.kmer_histogram(
                     s_pad, n_win, k, alpha.base)),
                 "last_path": ops.kmer_histogram.last_path,
                 "plain_ms": cuda_ms(lambda: kref.kmer_histogram_ref(
                     s_pad, n_win, k, alpha.base)),
                 "bound_ms": b_ms, "bound_by": b_by})
    del dev, ell, pt, s_dev, s_pad, got, want, pos2, pat2, mask2, len2
    torch.cuda.empty_cache()
    profiles = {"genome": build_profile("genome", s, alpha,
                                        t_prepare["genome"], build_counts)}

    # ---- 3-5. the protein path (build, check, serving; counted) ------------
    s_dna = s
    s = s_prot
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    report = BuildReport(VerticalStats(), PrepareStats())
    t0 = time.perf_counter()
    dev = EraIndexer(protein, cfg).build_device(s, report)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    after_build = counts_now()
    emit({"phase": "build", "dataset": "protein", "n": n,
          "memory_bytes": cfg.memory_bytes, "f_max": cfg.f_max,
          "t_total_s": t_build, "t_vertical_s": report.t_vertical,
          "t_prepare_s": report.t_prepare,
          "scans": report.vertical.scans,
          "iterations": report.prepare.iterations,
          "ranges": report.prepare.ranges,
          "active_history": report.prepare.active_history,
          "groups": report.n_groups, "prefixes": report.n_prefixes,
          "capacity": report.capacity, "n_subtrees": dev.n_subtrees,
          "k_route": dev.k_route, "n_iter": dev.n_iter,
          "packed": dev.packed, "string_nbytes": dev.string_nbytes,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": after_build})
    t_prepare["protein"] = report.t_prepare
    for name in ("kmer_histogram", "range_gather_pack", "lcp_pairs"):
        if after_build[name] <= 0:
            raise AssertionError(f"{name} was never launched by the "
                                 f"protein build")
    s_dev = torch.from_numpy(s).to(cuda)
    pats = make_workload(s, qrng, batch=64, min_len=4, max_len=24,
                         planted_frac=0.7, n_symbols=len(protein.symbols))
    emit({"phase": "check", "dataset": "protein",
          **check_index(dev, s, s_dev, pats, "protein"),
          "launches": counts_now()})
    stats = serve_index(dev, s, protein, np.random.default_rng(1),
                        batch=256, iters=20, min_len=4, max_len=24,
                        planted_frac=0.7)
    prot_counts = counts_now()
    emit({"phase": "serving", "dataset": "protein", **stats,
          "launches": prot_counts})
    require_launches(prot_counts, PROTEIN_KERNELS, "the protein path")
    if prot_counts["search_bounds_bytes"] <= after_build["search_bounds_bytes"]:
        raise AssertionError("the protein search never launched "
                             "search_bounds_bytes")
    if prot_counts["pattern_probe"]:
        raise AssertionError("the protein path launched the single-step probe")
    search_batch_launches(lambda: dev.find_batch_ranges(
        *dev.pad_batch(pats)), "search_bounds_bytes", "protein find_batch")
    ff_pats = make_workload(s, frng, batch=256, min_len=4, max_len=24,
                            planted_frac=0.7, n_symbols=len(protein.symbols))
    ff_check, prot_ff_counts = check_find_fetch(dev, s_dev, ff_pats,
                                                "protein find_fetch")
    emit({"phase": "find_fetch", "dataset": "protein", **ff_check,
          "launches": prot_ff_counts})
    require_fetch(prot_ff_counts, "protein", "the protein find-and-fetch path")
    emit({"phase": "find_fetch_latency", "dataset": "protein",
          "batch": len(ff_pats), **fetch_latency(dev, ff_pats)})
    prot_serve_counts = serving_stack(dev, s, protein, "protein")
    require_fetch(prot_serve_counts[FETCH], "protein",
                  "the protein serving stack")
    del s_dev

    # ---- 6b. protein kernels at the main path's shapes ---------------------
    # range_gather_pack + lcp_pairs: the first elastic step reads w = 4
    # symbols after every suffix from the build's padded text; in ell
    # (suffix-array) order the keys are sorted, as after the step's sort
    sp = EraIndexer(protein, cfg)._pad(s)
    ell = dev.ell
    got = ops.range_gather_pack(sp, ell, 4)
    want = kref.range_gather_pack_ref(sp, ell, 4)
    assert_equal(got, want, "range_gather_pack (main-path shape)")
    b_ms, b_by = bound(*gather_pack_work(ell.shape[0], 1, sp.shape[0]))
    # the same rows at 4-aligned offsets: what the unaligned reads cost
    ell_aligned = ell & ~3
    rows.append({"name": "range_gather_pack",
                 "replaces": "src/repro/kernels/range_gather.py:44",
                 "shape": f"rows={ell.shape[0]} w=4", "rows": ell.shape[0],
                 "ms": cuda_ms(lambda: ops.range_gather_pack(sp, ell, 4)),
                 "plain_ms": cuda_ms(
                     lambda: kref.range_gather_pack_ref(sp, ell, 4), reps=3),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "aligned_offsets_ms": cuda_ms(
                     lambda: ops.range_gather_pack(sp, ell_aligned, 4)),
                 "l2_window": l2_window_row(
                     lambda: ops.range_gather_pack(sp, ell, 4), sp)})
    # the untried fix of ROADMAP queue B: sort the positions first (the
    # gather on sorted rows, and the sort itself with its permutation)
    ell_sorted = torch.sort(ell).values
    rows[-1].update(
        sorted_offsets_ms=cuda_ms(
            lambda: ops.range_gather_pack(sp, ell_sorted, 4)),
        sort_ms=cuda_ms(lambda: torch.sort(ell), reps=3))
    del ell_aligned, ell_sorted
    keys = got
    prev = torch.cat([keys[:1], keys[:-1]]).contiguous()
    del want
    got = ops.lcp_pairs(prev, keys, 4)
    want = kref.lcp_pairs_ref(prev, keys, 4)
    for g, x, part in zip(got, want, ("lcp", "c1", "c2")):
        assert_equal(g, x, f"lcp_pairs {part} (main-path shape)")
    b_ms, b_by = bound(*lcp_work(keys.shape[0], 1))
    rows.append({"name": "lcp_pairs",
                 "replaces": "src/repro/kernels/lcp.py:47",
                 "shape": f"rows={keys.shape[0]} w=4",
                 "ms": cuda_ms(lambda: ops.lcp_pairs(prev, keys, 4)),
                 "plain_ms": cuda_ms(
                     lambda: kref.lcp_pairs_ref(prev, keys, 4), reps=3),
                 "bound_ms": b_ms, "bound_by": b_by})
    del got, want, keys, prev, sp
    # pattern_probe: one search step of a served batch (2B rows)
    pats = make_workload(s, qrng, batch=256, min_len=4, max_len=24,
                         planted_frac=0.7, n_symbols=len(protein.symbols))
    padded, lens, _ = dev.pad_batch(pats)
    pat_b, mask_b = _pack_query_batch(
        None, torch.from_numpy(padded).to(cuda),
        torch.from_numpy(lens).to(cuda), word=False)
    pat2 = torch.cat([pat_b, pat_b])
    mask2 = torch.cat([mask_b, mask_b])
    pos2 = ell[torch.randint(0, ell.shape[0], (pat2.shape[0],), device=cuda)]
    got = ops.pattern_probe(dev.s_text, pos2, pat2, mask2)
    want = kref.pattern_probe_ref(dev.s_text, pos2, pat2, mask2)
    assert_equal(got, want, "pattern_probe (main-path shape)")
    b_ms, b_by = bound(*probe_bytes_work(pat2.shape[0], pat2.shape[1],
                                         dev.s_text.shape[0]))
    rows.append({"name": "pattern_probe",
                 "replaces": "src/repro/kernels/pattern_probe.py:57",
                 "shape": f"rows={pat2.shape[0]} nw={pat2.shape[1]}",
                 "ms": cuda_ms(lambda: ops.pattern_probe(
                     dev.s_text, pos2, pat2, mask2), inner=100),
                 "plain_ms": cuda_ms(lambda: kref.pattern_probe_ref(
                     dev.s_text, pos2, pat2, mask2), inner=20),
                 "bound_ms": b_ms, "bound_by": b_by})
    rows.append(search_parity("bytes", dev, s, protein, "protein"))
    rows.append(fetch_parity("bytes", dev, s, protein, "protein"))

    del dev, ell, got, want, pos2, pat2, mask2
    torch.cuda.empty_cache()
    profiles["protein"] = build_profile("protein", s, protein,
                                        t_prepare["protein"], after_build)

    # ---- 6. the tree + analytics path per dataset (counted) ----------------
    def tree_path(name: str, sx: np.ndarray, ax) -> dict:
        """EraIndexer.build (node_lcp="words") -> SuffixTreeIndex ->
        analytics() -> the analytics_serve loop, counted from the build to
        the end of the loop; then the checks and the new kernel's row."""
        cfg_w = EraConfig(node_lcp="words")
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        report = BuildReport(VerticalStats(), PrepareStats())
        t0 = time.perf_counter()
        index = EraIndexer(ax, cfg_w).build(sx, report)
        torch.cuda.synchronize()
        t_total = time.perf_counter() - t0
        emit({"phase": "tree", "dataset": name, "n": len(sx) - 1,
              "node_lcp": "words", "t_total_s": t_total,
              "t_vertical_s": report.t_vertical,
              "t_prepare_s": report.t_prepare, "t_build_s": report.t_build,
              "iterations": report.prepare.iterations,
              "groups": report.n_groups, "prefixes": report.n_prefixes,
              "n_leaves": index.n_leaves, "n_internal": index.n_internal,
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "launches": counts_now()})
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = index.analytics()
        torch.cuda.synchronize()
        t_eng = time.perf_counter() - t0
        emit({"phase": "analytics", "dataset": name, "t_analytics_s": t_eng,
              "n_subtrees": eng.dev.n_subtrees, "levels": eng.vals.shape[0],
              "table_bytes": eng.vals.numel() * 4 + eng.vals_rev.numel() * 4,
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "launches": counts_now()})
        stats = serve_engine(eng, sx, ax, np.random.default_rng(1),
                             batch=512, iters=20, window=64,
                             planted_frac=0.7)
        counts = counts_now()
        emit({"phase": "analytics_serving", "dataset": name, **stats,
              "launches": counts})
        require_launches(counts, TREE_KERNELS[name], f"the {name} tree path")
        kernel = TREE_KERNELS[name][-1]
        if counts[SEARCH_STEPS[kernel]]:
            raise AssertionError(f"the {name} tree path launched the "
                                 f"single-step probe")
        q = make_query(sx, qrng, batch=512, planted_frac=0.7,
                       n_symbols=len(ax.symbols))
        search_batch_launches(lambda: eng.matching_stats(q, window=64),
                              kernel, f"{name} matching_stats")

        # -- tree checks: text-derived divergence rows == the prepare
        #    state's b_off on every sub-tree; find == brute force
        s_dev = torch.from_numpy(sx).to(cuda)
        prefixes = sorted(index.subtrees)
        freqs = np.array([index.subtrees[p].freq for p in prefixes])
        ell_all = np.concatenate([index.subtrees[p].ell for p in prefixes])
        boff_all = np.concatenate([index.subtrees[p].b_off
                                   for p in prefixes])
        inner = np.ones(ell_all.size, bool)
        inner[np.cumsum(freqs) - freqs] = False  # each sub-tree's first row
        text = EraIndexer(ax, cfg_w)._device_text(sx)
        t0 = time.perf_counter()
        rows = tbuild.boff_rows_from_text(
            text, torch.from_numpy(ell_all)[None].to(cuda), len(sx))[0]
        t_rows = time.perf_counter() - t0
        if not np.array_equal(rows.cpu().numpy()[inner], boff_all[inner]):
            raise AssertionError(f"{name}: boff_rows_from_text disagrees "
                                 f"with the prepare state's b_off")
        del rows
        pats = make_workload(sx, qrng, batch=64, min_len=4, max_len=24,
                             planted_frac=0.7, n_symbols=len(ax.symbols))
        for p in pats:
            want_pos = occurrences(s_dev, p).sort().values.cpu().numpy()
            if not np.array_equal(index.find(p), want_pos):
                raise AssertionError(f"{name}: find disagrees with the scan "
                                     f"for pattern {p.tolist()}")
        emit({"phase": "check", "dataset": name, "path": "tree",
              "boff_rows_equal": int(inner.sum()), "t_boff_rows_s": t_rows,
              "find_patterns": len(pats)})

        # -- analytics checks against brute force on the card
        total = eng.total
        ell_dev = eng.dev.ell
        bnd = eng.dev.sub_off[1:].to(torch.int64)
        rnd = torch.randint(1, total, (4096,), device=cuda)
        rows_q = torch.cat([bnd, rnd])
        want = brute_lcp(s_dev, ell_dev[rows_q - 1], ell_dev[rows_q])
        if not torch.equal(eng.lcp[rows_q].to(torch.int64), want):
            raise AssertionError(f"{name}: LCP array disagrees with brute "
                                 f"force")
        k = 6 if name == "genome" else 3
        starts, kcounts = eng.kmer_spectrum(k)
        hist = ops.kmer_histogram(s_dev, total - k + 1, k, ax.base)
        wins = s_dev[torch.from_numpy(starts).to(cuda)[:, None]
                     + torch.arange(k, device=cuda)].to(torch.int64)
        codes = torch.zeros(wins.shape[0], dtype=torch.int64, device=cuda)
        for j in range(k):
            codes = codes * ax.base + wins[:, j]
        if not (torch.equal(hist[codes].cpu().to(torch.int64),
                            torch.from_numpy(kcounts))
                and int((hist > 0).sum()) == len(kcounts)
                and int(hist.sum()) == int(kcounts.sum())):
            raise AssertionError(f"{name}: kmer_spectrum({k}) disagrees with "
                                 f"the kmer_histogram counts")
        rep = eng.longest_repeat()
        rep_p = sx[rep["witness"]:rep["witness"] + rep["length"]]
        rep_occ = int(occurrences(s_dev, rep_p).numel())
        if rep_occ != rep["count"]:
            raise AssertionError(f"{name}: longest repeat occurs {rep_occ} "
                                 f"times, the engine says {rep['count']}")
        q = make_query(sx, qrng, batch=512, planted_frac=0.7,
                       n_symbols=len(ax.symbols))
        ms, wit = eng.matching_stats(q, window=64)
        q_dev = torch.from_numpy(np.concatenate(
            [q, np.zeros(64, np.uint8)])).to(cuda)
        ar = torch.arange(64, device=cuda)
        has = torch.from_numpy(np.nonzero(ms > 0)[0]).to(cuda)
        ms_dev = torch.from_numpy(ms.astype(np.int64)).to(cuda)
        wit_dev = torch.from_numpy(wit.astype(np.int64)).to(cuda)
        in_match = ar[None, :] < ms_dev[has, None]
        s_win = s_dev[torch.clamp(wit_dev[has, None] + ar, max=len(sx) - 1)]
        q_win = q_dev[has[:, None] + ar]
        if bool(((s_win != q_win) & in_match).any()):
            raise AssertionError(f"{name}: a matching-statistics witness "
                                 f"does not match the query")
        open_pos = np.nonzero((ms < 64) & (np.arange(len(q)) + ms < len(q)))[0]
        sample = qrng.choice(open_pos, size=min(256, open_pos.size),
                             replace=False)
        for i in sample:
            if occurrences(s_dev, q[i:i + ms[i] + 1]).numel():
                raise AssertionError(f"{name}: matching statistic at {i} is "
                                     f"not maximal")
        emit({"phase": "check", "dataset": name, "path": "analytics",
              "lcp_rows_checked": int(rows_q.numel()),
              "boundaries": int(bnd.numel()), "kmer_k": k,
              "distinct_kmers": len(kcounts),
              "longest_repeat": rep, "matched_positions": int(has.numel()),
              "maximal_checked": int(sample.size),
              "distinct_substrings": eng.distinct_substrings()})
        del eng, s_dev, hist, wins, codes, q_dev, ms_dev, wit_dev, s_win
        del q_win, in_match, has, rows_q, want, ell_dev
        index._analytics = index._device = None
        torch.cuda.empty_cache()

        # -- the layers of the node build, each timed alone: the loop of
        #    EraIndexer._attach_nodes_batched split at its device syncs
        #    (padded rows + text-derived divergence rows, the chunked
        #    Cartesian-tree build, the compact extraction and host copy)
        t_rows = t_cart = t_host = 0.0
        cells, chunks = 0, 0
        ell_dev = torch.from_numpy(ell_all).to(cuda)
        first = np.cumsum(freqs) - freqs
        # CUDA events around each launch of the text-LCP kernel inside
        # boff_rows_from_text (as build_profile times the build's kernels):
        # per launch its w, pending rows, adjacency share and device ms
        lcp_attr = ("suffix_lcp_words" if isinstance(text, packing.PackedText)
                    else "_suffix_lcp_bytes")
        lcp_kernel = getattr(ops, lcp_attr)
        launches = []

        def timed_lcp(s_text, pa, pb, w):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = lcp_kernel(s_text, pa, pb, w)
            e1.record()
            adjacent = ((pa[1:] == pb[:-1]).sum() if pa.shape[0] > 1
                        else torch.zeros((), device=cuda))
            launches.append((w, pa.shape[0], adjacent, e0, e1))
            return out

        setattr(ops, lcp_attr, timed_lcp)
        try:
            for f_pad, bucket in tbuild.bucket_pad_widths(freqs):
                t0 = time.perf_counter()
                idx = np.zeros((len(bucket), f_pad), np.int64)
                for r, e in enumerate(bucket):
                    idx[r, :freqs[e]] = first[e] + np.arange(freqs[e])
                mask = torch.from_numpy(
                    np.arange(f_pad)[None, :] < freqs[bucket][:, None]
                ).to(cuda)
                ell_rows = torch.where(mask, ell_dev[torch.from_numpy(
                    idx).to(cuda)], len(sx))
                boff_rows = tbuild.boff_rows_from_text(text, ell_rows,
                                                       len(sx))
                torch.cuda.synchronize()
                t_rows += time.perf_counter() - t0
                t0 = time.perf_counter()
                nodes = tbuild.build_parallel_batch(ell_rows, boff_rows,
                                                    len(sx))
                torch.cuda.synchronize()
                t_cart += time.perf_counter() - t0
                t0 = time.perf_counter()
                tbuild.unpad_nodes_rows(nodes, freqs[bucket])
                t_host += time.perf_counter() - t0
                cells += len(bucket) * f_pad
                chunks += -(-len(bucket) // tbuild.rows_per_chunk(f_pad))
                del idx, mask, ell_rows, boff_rows, nodes
        finally:
            setattr(ops, lcp_attr, lcp_kernel)
        del ell_dev
        torch.cuda.empty_cache()
        # one lcp_from_text call per bucket: its rounds run w = 64, 128,
        # 256, 256, ...; a launch at the first w starts the next call
        rounds: list[dict] = []
        r = -1
        for w_l, rows_l, adj, e0, e1 in launches:
            r = 0 if w_l == launches[0][0] else r + 1
            if r == len(rounds):
                rounds.append({"round": r, "w": w_l, "launches": 0,
                               "rows": 0, "adjacent": 0, "ms": 0.0})
            rounds[r]["launches"] += 1
            rounds[r]["rows"] += rows_l
            rounds[r]["adjacent"] += int(adj)
            rounds[r]["ms"] += e0.elapsed_time(e1)
        for rd in rounds:
            rd["adjacent_share"] = rd.pop("adjacent") / max(rd["rows"], 1)
        lcp_ms = sum(rd["ms"] for rd in rounds)
        lcp_rows = sum(rd["rows"] for rd in rounds)
        tree_lcp = {"kernel": lcp_kernel.__name__,
                    "ms_in_tree": lcp_ms, "rows": lcp_rows,
                    "adjacent_share": (sum(rd["adjacent_share"] * rd["rows"]
                                           for rd in rounds)
                                       / max(lcp_rows, 1)),
                    # positions in, LCP out, per tallied row
                    "bound_ms": bound(lcp_rows * 12, 0)[0]}
        emit({"phase": "tree_layers", "dataset": name,
              "t_rows_and_text_lcp_s": t_rows, "t_cartesian_build_s": t_cart,
              "t_extract_to_host_s": t_host, "padded_cells": cells,
              "chunks": chunks, "text_lcp": tree_lcp,
              "text_lcp_glue_s": t_rows - lcp_ms / 1e3,
              "text_lcp_rounds": rounds})

        # -- the layers of the engine, each timed alone
        t0 = time.perf_counter()
        dev_i = index.to_device()
        torch.cuda.synchronize()
        t_flatten = time.perf_counter() - t0
        t0 = time.perf_counter()
        lcp_host = AnalyticsEngine.from_index(index, dev=dev_i).lcp_host
        torch.cuda.synchronize()
        t_from_index = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        AnalyticsEngine.from_device(dev_i, lcp_host)
        torch.cuda.synchronize()
        t_sparse = time.perf_counter() - t0
        emit({"phase": "analytics_layers", "dataset": name,
              "t_flatten_s": t_flatten, "t_sparse_tables_s": t_sparse,
              "t_lcp_fill_s": t_from_index - t_sparse})
        del dev_i
        torch.cuda.empty_cache()

        # -- the new kernel at the node build's main shape: the first
        #    lcp_from_text round reads every adjacent leaf pair at w = 64
        ell_t = torch.from_numpy(ell_all).to(cuda)
        pa = ell_t[:-1][torch.from_numpy(inner[1:]).to(cuda)].contiguous()
        pb = ell_t[1:][torch.from_numpy(inner[1:]).to(cuda)].contiguous()
        del ell_t
        w = 64
        chunk = 1 << 24
        if isinstance(text, packing.PackedText):
            kname, kfn, pfn = ("suffix_lcp_words", ops.suffix_lcp_words,
                               kref.suffix_lcp_words_ref)
            work = lambda lcp: suffix_lcp_work(lcp, w, text.syms_per_word,
                                               text.nbytes, 8)
            replaces = "src/repro/kernels/packed_gather.py:415"
        else:
            kname, kfn, pfn = ("suffix_lcp_pairs", ops.KERNELS["suffix_lcp_pairs"],
                               kref.suffix_lcp_pairs_ref)
            work = lambda lcp: suffix_lcp_work(lcp, w, 4, text.shape[0], 8)
            replaces = "src/repro/kernels/suffix_lcp.py:46"
        got = kfn(text, pa, pb, w)
        for c0 in range(0, pa.shape[0], chunk):  # the plain version in chunks
            assert_equal(got[c0:c0 + chunk],
                         pfn(text, pa[c0:c0 + chunk], pb[c0:c0 + chunk], w),
                         f"{kname} (main-path shape)")
        b_ms, b_by = bound(*work(got))
        call = lambda: kfn(text, pa, pb, w)
        earlier = {}
        if kname in yard:  # the earlier design, in turns on the same pairs
            old = lambda: hist_lcp_bench.baseline_slcp(yard[kname], text, pa,
                                                       pb, w)
            assert_equal(old(), got, f"{kname}'s earlier design")
            ms, old_ms = gather_bench.in_turns(
                {"ms": call, "baseline_ms": old}).values()
            earlier = {"design": DESIGNS[kname][0], "baseline_ms": old_ms,
                       "baseline_design": DESIGNS[kname][1]}
        else:
            ms = cuda_ms(call)
        row = {"name": kname, "replaces": replaces,
               "shape": f"rows={pa.shape[0]} w={w}",
               "adjacent_share": float((pa[1:] == pb[:-1]).float().mean()),
               "ms_in_tree": {name: {"ms_in_tree": tree_lcp["ms_in_tree"],
                                     "bound_ms": tree_lcp["bound_ms"],
                                     "rows": tree_lcp["rows"]}},
               "ms": ms, **earlier,
               "plain_ms": cuda_ms(lambda: [
                   pfn(text, pa[c0:c0 + chunk], pb[c0:c0 + chunk], w)
                   for c0 in range(0, pa.shape[0], chunk)], reps=1),
               "bound_ms": b_ms, "bound_by": b_by,
               "plain_note": f"plain version run in chunks of {chunk} rows"}
        del got, pa, pb, text, index
        torch.cuda.empty_cache()
        return {"counts": counts, "row": row}

    from repro_torch.core.analytics import AnalyticsEngine
    qrng = np.random.default_rng(13)
    tree = {"genome": tree_path("genome", s_dna, alpha),
            "protein": tree_path("protein", s_prot, protein)}
    rows += [tree["genome"]["row"], tree["protein"]["row"]]
    del s_prot

    # ---- 7. the REPRO_WORD_COMPARE=byte oracle leg on genome (counted) ------
    n_leg = 1 << min(BYTE_LEG_LOG2, args.n_log2)
    s_leg, _ = dataset("genome", n_leg, seed=0)
    leg_pats = make_workload(s_leg, qrng, batch=64, min_len=4, max_len=24,
                             planted_frac=0.7, n_symbols=len(alpha.symbols))
    leg_q = make_query(s_leg, qrng, batch=512, planted_frac=0.7,
                       n_symbols=len(alpha.symbols))
    legs = {}
    for leg in ("word", "byte"):
        with gather_bench.word_compare(leg):
            ops.reset_launch_counts()
            report = BuildReport(VerticalStats(), PrepareStats())
            t0 = time.perf_counter()
            dev = EraIndexer(alpha, cfg).build_device(s_leg, report)
            torch.cuda.synchronize()
            t_leg = time.perf_counter() - t0
            leg_build = counts_now()
            found = dev.find_batch(leg_pats)
            fetched = dev.find_fetch_batch(leg_pats, fetch=FETCH)
            _, eng = EraIndexer(alpha, EraConfig(build_impl="none")
                                ).build_analytics(s_leg)
            ms_leg = eng.matching_stats(leg_q, window=64)
            legs[leg] = {"ell": dev.ell.cpu().numpy(), "found": found,
                         "fetched": fetched,
                         "lcp": eng.lcp_host, "ms": ms_leg,
                         "counts": counts_now(), "t_build_s": t_leg,
                         "t_prepare_s": report.t_prepare,
                         "build_counts": leg_build}
            if leg == "byte":
                leg_ell = dev.ell
            del dev, eng
            torch.cuda.empty_cache()
    # one more warm byte-leg build under the profiler: the byte-key
    # kernels' device ms in the build beside their bounds
    with gather_bench.word_compare("byte"):
        profiles["byte_leg"] = build_profile(
            "byte_leg", s_leg, alpha, legs["byte"]["t_prepare_s"],
            legs["byte"]["build_counts"])
    wl, bl = legs["word"], legs["byte"]
    same = (np.array_equal(wl["ell"], bl["ell"])
            and all(np.array_equal(a, b)
                    for a, b in zip(wl["found"], bl["found"]))
            and all(np.array_equal(a, b)
                    for a, b in zip(bl["found"], bl["fetched"][0]))
            and all(np.array_equal(a, b)
                    for a, b in zip(wl["fetched"][0], bl["fetched"][0]))
            and np.array_equal(wl["fetched"][1], bl["fetched"][1])
            and np.array_equal(wl["lcp"], bl["lcp"])
            and all(np.array_equal(a, b) for a, b in zip(wl["ms"], bl["ms"])))
    emit({"phase": "byte_leg", "dataset": "genome", "n": n_leg,
          "equal_to_word_leg": same,
          "t_build_word_s": wl["t_build_s"], "t_build_byte_s": bl["t_build_s"],
          "launches_word": wl["counts"], "launches": bl["counts"]})
    if not same:
        raise AssertionError("the byte leg disagrees with the word leg")
    require_launches(bl["counts"], BYTE_LEG_KERNELS, "the byte leg")
    for name in WORD_ONLY_KERNELS:
        if bl["counts"][name]:
            raise AssertionError(f"{name} ran under REPRO_WORD_COMPARE=byte")

    # range_gather_packed at the byte leg's main shape: the first elastic
    # step reads w = 4 symbols after every suffix of the dense build text
    pt_leg = EraIndexer(alpha, cfg)._device_text(s_leg)
    got = ops.range_gather_packed(pt_leg, leg_ell, 4)
    want = kref.range_gather_packed_ref(pt_leg, leg_ell, 4)
    assert_equal(got, want, "range_gather_packed (main-path shape)")
    old = lambda: gather_bench.baseline_packed(yard["range_gather_packed"],
                                               pt_leg, leg_ell, 4)
    assert_equal(old(), want, "range_gather_packed's earlier design")
    b_ms, b_by = bound(*gather_packed_work(leg_ell.shape[0], 1, pt_leg.bits,
                                           pt_leg.words.shape[0]))
    ms, old_ms = gather_bench.in_turns({
        "ms": lambda: ops.range_gather_packed(pt_leg, leg_ell, 4),
        "baseline_ms": old}).values()
    rows.append({"name": "range_gather_packed",
                 "replaces": "src/repro/kernels/packed_gather.py:93",
                 "shape": f"rows={leg_ell.shape[0]} w=4",
                 "rows": leg_ell.shape[0], "ms": ms,
                 "design": DESIGNS["range_gather_packed"][0],
                 "baseline_ms": old_ms,
                 "baseline_design": DESIGNS["range_gather_packed"][1],
                 "plain_ms": cuda_ms(lambda: kref.range_gather_packed_ref(
                     pt_leg, leg_ell, 4), reps=3),
                 "bound_ms": b_ms, "bound_by": b_by})
    del got, want, pt_leg, leg_ell, old

    # ---- 9. LM serving: qwen3-1.7b prefill -> decode (flash_attention) ----
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "lm_start",
          "allocated_gb": torch.cuda.memory_allocated() / 1e9})
    flash_cases = flash_parity(cuda)
    lm_runs = lm_serving(cuda)
    lm_check(cuda)

    rows += fetch_rows
    rows.append(flash_row(cuda, flash_cases))  # row 13, the last ported
    # the LM's main path is one serve call: the warm run, counted from 0
    lm_main = next(r["launches"] for r in lm_runs if r["run"] == "warm")
    paths = [dna_counts, term_counts, ff_counts, tff_counts,
             *dna_serve_counts.values(), prot_counts, prot_ff_counts,
             *prot_serve_counts.values(), tree["genome"]["counts"],
             tree["protein"]["counts"], bl["counts"], lm_main]
    counts = {name: sum(c[name] for c in paths) for name in ops.KERNELS}
    for row in rows:  # a gather's excess from the rows its launches read
        if row["name"] in GATHERS:
            got_rows, got_words = (sum(c.get(f"{row['name']}_{k}", 0)
                                       for c in paths)
                                   for k in ("rows", "words"))
            row.update(rows_gathered=got_rows, words_gathered=got_words,
                       row_weighted_excess_ms=got_rows / row["rows"]
                       * (row["ms"] - row["bound_ms"]))
        in_build = {d: {k: p["port_kernels"][row["name"]][k]
                        for k in ("ms_in_build", "bound_ms", "excess_ms")}
                    for d, p in profiles.items()
                    if row["name"] in p["port_kernels"]}
        if in_build:
            row["ms_in_build"] = in_build
    for row in rows:
        if row["name"] == "kmer_histogram":  # every counted partition scan
            row["per_k_ms"] = {f"{d} k={k}": v["ms"]
                               for (d, k), v in kmer_rows.items()}
            row["per_k_path"] = {f"{d} k={k}": v["last_path"]
                                 for (d, k), v in kmer_rows.items()}
            row["bincount_ms"] = kmer_rows[("genome", 6)]["bincount_ms"]
            row["bincount_note"] = (
                "torch.bincount of the precomputed codes at the row's shape: "
                "a yardstick for the counting step alone, not the function")
        if row["name"] == "suffix_lcp_words":
            row["w256_ms"] = lcp_w256
    kernels = []
    for row in rows:
        kernels.append({"name": row["name"], "route": "cuda",
                        "source": row.get("source", f"src/repro_torch/kernels/"
                                                    f"csrc/{row['name']}.cu"),
                        "replaces": row["replaces"],
                        "launches": counts[row["name"]],
                        "max_abs_err": row.get("max_abs_err", 0),
                        "ms": row["ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row.get("library_ms"),
                        "shape": row["shape"],
                        # what the redesign queue ranks by (ROADMAP)
                        "launch_excess_ms": counts[row["name"]]
                        * (row["ms"] - row["bound_ms"]),
                        **{k: v for k, v in row.items()
                           if k in ("aligned_offsets_ms", "plain_note",
                                    "two_launch_ms", "large", "library",
                                    "design", "sorted_offsets_ms",
                                    "sort_ms", "rows_gathered",
                                    "words_gathered", "ms_in_build",
                                    "l2_window",
                                    "row_weighted_excess_ms", "loop_ms",
                                    "replaces_loop", "bound_note",
                                    "trips_max", "trips_mean", "n_iter",
                                    "window_max", "window_mean",
                                    "last_path", "per_k_ms", "per_k_path",
                                    "bincount_ms", "bincount_note",
                                    "adjacent_share", "w256_ms",
                                    "ms_in_tree", "unfused_ms",
                                    "latency_bound_ms", "dram_round_trip_ms",
                                    "replaces_composition", "search_ms",
                                    "device_ms", "unfused_device_ms",
                                    "search_device_ms", "baseline_ms",
                                    "baseline_design")}})
    if sorted(k["name"] for k in kernels) != sorted(ops.KERNELS):
        raise AssertionError("the kernels line misses a kernel")
    print(nvidia_smi(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

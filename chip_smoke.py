#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port's ported paths.

Drives ``repro_torch`` on one CUDA card, through the entry points a user
calls, at chromosome scale (n = 2**27 symbols by default) on two paths:

* the DNA path — the ``genome`` dataset, dense 2-bit words
  (``range_gather_words``, ``pattern_probe_words``, ``kmer_histogram``),
  plus a batch carrying the terminal code (``pattern_probe_packed``);
* the protein path — the ``protein`` dataset, byte-per-symbol text, the
  byte-key currency (``range_gather_pack``, ``lcp_pairs``,
  ``pattern_probe``, and ``kmer_histogram`` for the partition).

Phases, each printing one JSON line:

1. device   — the card (``nvidia-smi`` name and power limit), torch/CUDA
              versions, and the build of every CUDA kernel from ``csrc/``;
2. parity   — each hand kernel against its plain PyTorch version on the
              card, exact equality (integer kernels), with its time;
3. build    — ``EraIndexer(alphabet, EraConfig()).build_device(s)``;
4. check    — ``ell`` is a permutation of the suffixes, and ``find_batch``
              equals a brute-force occurrence scan on the device (for DNA
              also on a batch of patterns ending in the terminal code);
5. serving  — the ``query_serve`` loop (batch 256, lengths 4–24);
6. kernels  — each kernel at the main path's shapes: time, plain-version
              time, bound, and its launches on the paths above.

Launch counts are set to 0 just before each path (build + check +
serving, and the terminal-bearing check) and read just after; the build,
check and serving lines carry the counts so far.  Every kernel of a path
must have launched in it.  Any failure raises and exits
non-zero.  The last line is ``{"ok": true, "device": {...}}``.  Without a
CUDA card, or without the rest of the repository, the script exits
non-zero and prints no result.

  python3 chip_smoke.py                # n = 2**27 (the default)
  python3 chip_smoke.py --n-log2 20    # a short compile-and-check run
"""

from __future__ import annotations

import argparse
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
DNA_KERNELS = ("range_gather_words", "pattern_probe_words", "kmer_histogram")
TERMINAL_KERNELS = ("pattern_probe_packed",)
PROTEIN_KERNELS = ("kmer_histogram", "range_gather_pack", "lcp_pairs",
                   "pattern_probe")


def emit(obj) -> None:
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-log2", type=int, default=27,
                    help="index the genome and protein datasets at n = 2**N")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import packing
    from repro_torch.core.api import BuildReport, EraConfig, EraIndexer
    from repro_torch.core.prepare import PrepareStats, _pair_lanes, _stable_order
    from repro_torch.core.query import _pack_query_batch
    from repro_torch.core.vertical import VerticalStats
    from repro_torch.data.strings import dataset
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import ref as kref
    from repro_torch.launch.query_serve import make_workload, serve_index

    cuda = torch.device("cuda")
    # ---- 1. device --------------------------------------------------------
    smi = nvidia_smi()
    t0 = time.perf_counter()
    compile_s = _build.build_all()
    t_build_kernels = time.perf_counter() - t0
    for name in _build.SOURCES:  # load every library once
        _build.library(name)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernel_build_s": t_build_kernels,
          "nvcc_s": compile_s, "build_dir": str(_build.build_dir())})
    for name in _build.SOURCES:  # registers / spills from -Xptxas -v
        log = (_build.build_dir() / f"{name}.log")
        if log.exists():
            lines = [l.strip() for l in log.read_text().splitlines()
                     if "registers" in l or "spill" in l]
            emit({"phase": "ptxas", "kernel": name, "report": lines})

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

    s_pad = torch.from_numpy(np.concatenate(
        [s, np.full(8, alpha.terminal_code, np.uint8)])).to(cuda)
    n_win = len(s)
    for k in range(1, 7):
        got = ops.kmer_histogram(s_pad, n_win, k, alpha.base)
        want = kref.kmer_histogram_ref(s_pad, n_win, k, alpha.base)
        assert_equal(got, want, f"kmer_histogram k={k}")
        assert int(got.sum()) == n_win
        b_ms, b_by = bound(*kmer_work(n_win, k, alpha.base))
        emit({"phase": "parity", "kernel": "kmer_histogram", "n": n_win,
              "k": k, "bins": alpha.base**k, "max_abs_err": 0,
              "shared_memory": ops.kmer_histogram.last_used_smem,
              "ms": cuda_ms(lambda: ops.kmer_histogram(
                  s_pad, n_win, k, alpha.base)),
              "plain_ms": cuda_ms(lambda: kref.kmer_histogram_ref(
                  s_pad, n_win, k, alpha.base)),
              "bound_ms": b_ms, "bound_by": b_by})
    del offs, got, want, pat_d, mask_d, pat_b, mask_b
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
    after_build = ops.launch_counts()
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
    s_dev = torch.from_numpy(s).to(cuda)
    qrng = np.random.default_rng(11)
    pats = make_workload(s, qrng, batch=64, min_len=4, max_len=24,
                         planted_frac=0.7, n_symbols=len(alpha.symbols))
    emit({"phase": "check", "dataset": "genome",
          **check_index(dev, s, s_dev, pats, "genome"),
          "launches": ops.launch_counts()})
    stats = serve_index(dev, s, alpha, np.random.default_rng(1),
                        batch=256, iters=20, min_len=4, max_len=24,
                        planted_frac=0.7)
    dna_counts = ops.launch_counts()
    emit({"phase": "serving", "dataset": "genome", **stats,
          "launches": dna_counts})
    require_launches(dna_counts, DNA_KERNELS, "the DNA path")
    for name in ("range_gather_words", "kmer_histogram"):
        if after_build[name] <= 0:
            raise AssertionError(f"{name} was never launched by the build")
    if dna_counts["pattern_probe_words"] <= after_build["pattern_probe_words"]:
        raise AssertionError("the search never launched pattern_probe_words")

    # ---- 4b. the DNA terminal-bearing batch (counted) ----------------------
    term = alpha.terminal_code
    tpats = [np.asarray(s[len(s) - k:]) for k in (1, 2, 3, 5, 9, 17, 24)]
    tpats += [np.array([c, term], np.uint8) for c in range(term)]
    tpats += make_workload(s, qrng, batch=8, min_len=4, max_len=24,
                           planted_frac=0.7, n_symbols=len(alpha.symbols))
    ops.reset_launch_counts()
    term_check = check_index(dev, s, s_dev, tpats, "genome terminal batch")
    term_counts = ops.launch_counts()
    emit({"phase": "check", "dataset": "genome", "batch": "terminal-bearing",
          **term_check, "launches": term_counts})
    require_launches(term_counts, TERMINAL_KERNELS, "the terminal batch")
    if term_counts["pattern_probe_words"] != 0:
        raise AssertionError("a terminal-bearing batch took the word probe")

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
    rows.append({"name": "range_gather_words",
                 "replaces": "src/repro/kernels/packed_gather.py:265",
                 "shape": f"rows={ell.shape[0]} w=4",
                 "ms": cuda_ms(lambda: ops.range_gather_words(pt, ell, 4)),
                 "plain_ms": cuda_ms(
                     lambda: kref.range_gather_words_ref(pt, ell, 4), reps=3),
                 "bound_ms": b_ms, "bound_by": b_by})
    del got, want
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
    # kmer_histogram: the deepest kernel-counted DNA partition scan (t = 6)
    k = 6
    b_ms, b_by = bound(*kmer_work(n_win, k, alpha.base))
    rows.append({"name": "kmer_histogram",
                 "replaces": "src/repro/kernels/kmer_histogram.py:46",
                 "shape": f"n={n_win} k={k}",
                 "ms": cuda_ms(lambda: ops.kmer_histogram(
                     s_pad, n_win, k, alpha.base)),
                 "plain_ms": cuda_ms(lambda: kref.kmer_histogram_ref(
                     s_pad, n_win, k, alpha.base)),
                 "bound_ms": b_ms, "bound_by": b_by})
    del dev, ell, pt, s_dev, s_pad, got, want, pos2, pat2, mask2, len2
    torch.cuda.empty_cache()

    # ---- 3-5. the protein path (build, check, serving; counted) ------------
    s = s_prot
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    report = BuildReport(VerticalStats(), PrepareStats())
    t0 = time.perf_counter()
    dev = EraIndexer(protein, cfg).build_device(s, report)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    after_build = ops.launch_counts()
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
    for name in ("kmer_histogram", "range_gather_pack", "lcp_pairs"):
        if after_build[name] <= 0:
            raise AssertionError(f"{name} was never launched by the "
                                 f"protein build")
    s_dev = torch.from_numpy(s).to(cuda)
    pats = make_workload(s, qrng, batch=64, min_len=4, max_len=24,
                         planted_frac=0.7, n_symbols=len(protein.symbols))
    emit({"phase": "check", "dataset": "protein",
          **check_index(dev, s, s_dev, pats, "protein"),
          "launches": ops.launch_counts()})
    stats = serve_index(dev, s, protein, np.random.default_rng(1),
                        batch=256, iters=20, min_len=4, max_len=24,
                        planted_frac=0.7)
    prot_counts = ops.launch_counts()
    emit({"phase": "serving", "dataset": "protein", **stats,
          "launches": prot_counts})
    require_launches(prot_counts, PROTEIN_KERNELS, "the protein path")
    if prot_counts["pattern_probe"] <= after_build["pattern_probe"]:
        raise AssertionError("the protein search never launched pattern_probe")
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
                 "shape": f"rows={ell.shape[0]} w=4",
                 "ms": cuda_ms(lambda: ops.range_gather_pack(sp, ell, 4)),
                 "plain_ms": cuda_ms(
                     lambda: kref.range_gather_pack_ref(sp, ell, 4), reps=3),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "aligned_offsets_ms": cuda_ms(
                     lambda: ops.range_gather_pack(sp, ell_aligned, 4))})
    del ell_aligned
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

    counts = {name: dna_counts[name] + term_counts[name] + prot_counts[name]
              for name in ops.KERNELS}
    kernels = []
    for row in rows:
        kernels.append({"name": row["name"], "route": "cuda",
                        "source": f"src/repro_torch/kernels/csrc/"
                                  f"{row['name']}.cu",
                        "replaces": row["replaces"],
                        "launches": counts[row["name"]], "max_abs_err": 0,
                        "ms": row["ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": None,
                        "shape": row["shape"],
                        **{k: v for k, v in row.items()
                           if k == "aligned_offsets_ms"}})
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

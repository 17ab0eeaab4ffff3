"""Sustained batched analytics serving driver — PyTorch port of
``repro.launch.analytics_serve``.

Builds an ERA index over a dataset (:meth:`EraIndexer.build_analytics`),
lifts it into the device-resident
:class:`repro_torch.core.analytics.AnalyticsEngine`, then drives a loop of
matching-statistics batches (one query string in, per-position
longest-match lengths and witnesses out) and reports positions/s and
per-batch latency.  Repeat mining and the distinct-substring count are
one-shot index-wide passes, reported once.  Runs on the card by default:

  PYTHONPATH=src python -m repro_torch.launch.analytics_serve --dataset dna \
      --n 100000 --batch 512 --iters 20 --index-path /tmp/era_analytics.npz
  (--device cpu runs the plain PyTorch versions)
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core.analytics import AnalyticsEngine
from repro_torch.core.api import EraConfig, EraIndexer
from repro_torch.launch.warmstart import load_or_build


def make_query(s: np.ndarray, rng: np.random.Generator, *, batch: int,
               planted_frac: float, n_symbols: int) -> np.ndarray:
    """A query string of ``batch`` positions: planted slices of S (long
    matches) spliced with random stretches (short matches)."""
    out = np.empty(batch, np.uint8)
    i = 0
    while i < batch:
        m = int(rng.integers(8, 65))
        m = min(m, batch - i)
        if rng.random() < planted_frac:
            j = int(rng.integers(0, len(s) - 1 - m))
            out[i : i + m] = s[j : j + m]
        else:
            out[i : i + m] = rng.integers(0, n_symbols, size=m)
        i += m
    return out


def serve_engine(eng: AnalyticsEngine, s: np.ndarray, alphabet,
                 rng: np.random.Generator, *, batch: int = 512,
                 iters: int = 20, window: int = 64,
                 planted_frac: float = 0.7) -> dict:
    """The timed matching-statistics loop over a built engine: ``iters``
    queries of ``batch`` positions, one warm-up, then each batch timed
    from dispatch to its result on the host."""
    if len(s) <= 66:  # make_query plants slices up to 64 symbols
        raise ValueError(f"indexed string too short ({len(s)} symbols)")
    queries = [make_query(s, rng, batch=batch, planted_frac=planted_frac,
                          n_symbols=len(alphabet.symbols))
               for _ in range(iters)]
    eng.matching_stats(queries[0], window=window)  # warm-up

    lat = []
    matched = 0
    t0 = time.perf_counter()
    for q in queries:
        t1 = time.perf_counter()
        ms, _ = eng.matching_stats(q, window=window)  # ends on the host
        lat.append(time.perf_counter() - t1)
        matched += int(ms.sum())
    t_serve = time.perf_counter() - t0
    lat = np.array(lat)
    return {
        "device": str(eng.dev.device),
        "n_symbols": eng.total,
        "n_subtrees": eng.dev.n_subtrees,
        "batches": iters,
        "batch": batch,
        "positions": iters * batch,
        "mean_match_len": matched / (iters * batch),
        "positions_per_s": iters * batch / max(t_serve, 1e-9),
        "batch_p50_ms": float(np.percentile(lat, 50)) * 1e3,
        "batch_p99_ms": float(np.percentile(lat, 99)) * 1e3,
    }


def serve_analytics(dataset_name: str = "dna", *, n: int = 100_000,
                    batch: int = 512, iters: int = 20, window: int = 64,
                    planted_frac: float = 0.7, memory_bytes: int = 1 << 20,
                    seed: int = 0, index_path: str | None = None,
                    device="cuda") -> dict:
    """Build (or warm-start) the engine over ``dataset(dataset_name, n,
    seed)`` on ``device``, report the one-shot passes, and run
    :func:`serve_engine`."""
    if iters < 1 or batch < 1:
        raise ValueError(f"need iters >= 1 and batch >= 1, got {iters}, {batch}")
    rng = np.random.default_rng(seed + 1)

    def build(s, alphabet):
        cfg = EraConfig(memory_bytes=memory_bytes, build_impl="none")
        return EraIndexer(alphabet, cfg, device=device).build_analytics(s)[1]

    # warm start: one npz holds the flattened index AND the LCP array
    eng, s, alphabet, t_build = load_or_build(
        index_path, dataset_name, n, seed,
        load=lambda path: AnalyticsEngine.load(path, device=device),
        build=build, dev_of=lambda e: e.dev)
    rep = eng.longest_repeat()
    stats = serve_engine(eng, s, alphabet, rng, batch=batch, iters=iters,
                         window=window, planted_frac=planted_frac)
    return {"dataset": dataset_name, "t_build_s": t_build,
            "longest_repeat": None if rep is None else rep["length"],
            "distinct_substrings": eng.distinct_substrings(), **stats}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="dna",
                    choices=["dna", "genome", "protein", "english", "byte"])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--batch", type=int, default=512,
                    help="query positions per batch (the query length)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--window", type=int, default=64,
                    help="matching-statistics length cap")
    ap.add_argument("--planted-frac", type=float, default=0.7)
    ap.add_argument("--index-path", default=None,
                    help="npz cache: load index+LCP if the file exists, "
                         "else build once and save there")
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand kernels) or cpu (plain PyTorch versions)")
    args = ap.parse_args()
    stats = serve_analytics(args.dataset, n=args.n, batch=args.batch,
                            iters=args.iters, window=args.window,
                            planted_frac=args.planted_frac,
                            index_path=args.index_path, device=args.device)
    print(stats)


if __name__ == "__main__":
    main()

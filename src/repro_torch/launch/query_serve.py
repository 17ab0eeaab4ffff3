"""Sustained batched query serving driver — PyTorch port of
``repro.launch.query_serve``.

Builds an ERA index over a dataset with
:meth:`repro_torch.core.api.EraIndexer.build_device`, then drives a
sustained loop of padded pattern batches through
``DeviceIndex.find_batch_ranges`` and reports queries/sec plus per-batch
latency.  Every dataset runs: ``dna``/``genome`` index dense 2-bit words,
``protein``/``english``/``byte`` the byte-per-symbol text (byte-key
kernels).  ``--index-path`` warm-starts from an npz archive (written by a
cold run; the JAX package's archives load too).  Runs on the card by
default:

  PYTHONPATH=src python -m repro_torch.launch.query_serve --dataset protein \
      --n 100000 --batch 256 --iters 20            # --device cpu: plain path
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.api import EraConfig, EraIndexer
from repro_torch.core.query import DeviceIndex
from repro_torch.launch.warmstart import load_or_build, will_load


def make_workload(s: np.ndarray, rng: np.random.Generator, *, batch: int,
                  min_len: int, max_len: int, planted_frac: float,
                  n_symbols: int) -> list[np.ndarray]:
    """A batch mixing planted substrings (guaranteed hits) with random
    patterns (mostly misses) across a uniform length mix."""
    pats = []
    for _ in range(batch):
        m = int(rng.integers(min_len, max_len + 1))
        if rng.random() < planted_frac:
            i = int(rng.integers(0, len(s) - 1 - m))
            pats.append(np.asarray(s[i : i + m]))
        else:
            pats.append(rng.integers(0, n_symbols, size=m).astype(np.uint8))
    return pats


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_index(dev, s: np.ndarray, alphabet, rng: np.random.Generator, *,
                batch: int = 256, iters: int = 20, min_len: int = 4,
                max_len: int = 24, planted_frac: float = 0.7) -> dict:
    """The timed serving loop over a built :class:`DeviceIndex`: pre-pad
    ``iters`` batches, warm up once per padded width, then time each
    batch from dispatch to a synchronised result."""
    if max_len >= len(s) - 1:  # need a valid start for every planted length
        raise ValueError(
            f"max_len {max_len} must be < indexed string length - 1 = {len(s) - 1}")
    batches = []
    for _ in range(iters):
        pats = make_workload(s, rng, batch=batch, min_len=min_len,
                             max_len=max_len, planted_frac=planted_frac,
                             n_symbols=len(alphabet.symbols))
        batches.append(dev.pad_batch(pats))

    warmed: set[int] = set()
    for padded, lengths, route in batches:
        if padded.shape[1] in warmed:
            continue
        warmed.add(padded.shape[1])
        dev.find_batch_ranges(padded, lengths, route)
        _sync(dev.device)

    lat = []
    hits = 0
    t0 = time.perf_counter()
    for padded, lengths, route in batches:
        t1 = time.perf_counter()
        start, count = dev.find_batch_ranges(padded, lengths, route)
        _sync(dev.device)
        lat.append(time.perf_counter() - t1)
        hits += int(count.sum())
    t_serve = time.perf_counter() - t0

    lat = np.array(lat)
    return {
        "device": str(dev.device),
        "n_symbols": len(s),
        "n_subtrees": dev.n_subtrees,
        "k_route": dev.k_route,
        "n_iter": dev.n_iter,
        "batches": iters,
        "batch": batch,
        "queries": iters * batch,
        "hits": hits,
        "qps": iters * batch / max(t_serve, 1e-9),
        "batch_p50_ms": float(np.percentile(lat, 50)) * 1e3,
        "batch_p99_ms": float(np.percentile(lat, 99)) * 1e3,
    }


def serve_queries(dataset_name: str = "dna", *, n: int = 100_000,
                  batch: int = 256, iters: int = 20, min_len: int = 4,
                  max_len: int = 24, planted_frac: float = 0.7,
                  memory_bytes: int = 1 << 20, seed: int = 0,
                  index_path: str | None = None, device="cuda") -> dict:
    """Build an index over ``dataset(dataset_name, n, seed)`` on ``device``
    (or load it from the npz at ``index_path``, which a cold run writes;
    archives of either package load) and run :func:`serve_index` on it."""
    if not 1 <= min_len <= max_len:
        raise ValueError(f"need 1 <= min_len <= max_len, got [{min_len}, {max_len}]")
    if iters < 1 or batch < 1:
        raise ValueError(f"need iters >= 1 and batch >= 1, got {iters}, {batch}")
    rng = np.random.default_rng(seed + 1)
    max_len4 = -(-max_len // 4) * 4  # pad_batch rounds to whole packed words
    if not will_load(index_path) and max_len >= n:
        # cold path: fail before paying the build
        raise ValueError(f"max_len {max_len} must be < --n {n}")

    def build(s, alphabet):
        cfg = EraConfig(memory_bytes=memory_bytes, build_impl="none")
        dev = EraIndexer(alphabet, cfg, device=device).build_device(
            s, max_pattern_len=max(64, max_len4))
        _sync(dev.device)
        return dev

    dev, s, alphabet, t_build = load_or_build(
        index_path, dataset_name, n, seed,
        load=lambda path: DeviceIndex.load(path, device=device), build=build)
    if max_len4 > dev.max_pattern_len:
        raise ValueError(
            f"--max-len {max_len} exceeds the cached index's "
            f"max_pattern_len={dev.max_pattern_len}; delete the cache at "
            f"--index-path or rebuild cold with a larger --max-len")
    stats = serve_index(dev, s, alphabet, rng, batch=batch, iters=iters,
                        min_len=min_len, max_len=max_len,
                        planted_frac=planted_frac)
    return {"dataset": dataset_name, "t_build_s": t_build, **stats}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="dna",
                    choices=["dna", "genome", "protein", "english", "byte"])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--min-len", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=24)
    ap.add_argument("--planted-frac", type=float, default=0.7)
    ap.add_argument("--index-path", default=None,
                    help="npz cache: load the flattened index if the file "
                         "exists, else build once and save it there")
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand kernels) or cpu (plain PyTorch versions)")
    args = ap.parse_args()
    stats = serve_queries(args.dataset, n=args.n, batch=args.batch,
                          iters=args.iters, min_len=args.min_len,
                          max_len=args.max_len,
                          planted_frac=args.planted_frac,
                          index_path=args.index_path, device=args.device)
    print(stats)


if __name__ == "__main__":
    main()

"""End-to-end driver on the PyTorch port — the paper's headline scenario:
index a genome-scale string under a memory budget much smaller than |S|,
report the phase breakdown and the I/O model, persist, reload, and answer
queries.

    PYTHONPATH=src python examples/torch_genome_indexing.py --n 2000000 --mem-kb 256
    PYTHONPATH=src python examples/torch_genome_indexing.py --device cpu --n 200000
"""

import argparse
import time
from pathlib import Path

import numpy as np

from repro_torch.core.api import BuildReport, EraConfig, EraIndexer
from repro_torch.core.iomodel import amortization_factor
from repro_torch.core.prepare import PrepareStats
from repro_torch.core.suffix_tree import SuffixTreeIndex
from repro_torch.core.vertical import VerticalStats
from repro_torch.data.strings import dataset

OUT = Path(__file__).resolve().parents[1] / "build" / "genome_index.npz"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--mem-kb", type=int, default=256)
    ap.add_argument("--dataset", default="genome")
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand kernels) or cpu (plain PyTorch "
                         "versions) [cuda]")
    args = ap.parse_args()

    s, alphabet = dataset(args.dataset, args.n, seed=0)
    ratio = len(s) / (args.mem_kb << 10)
    print(f"indexing {len(s):,} symbols with a {args.mem_kb}KB budget "
          f"(string is {ratio:.0f}x the memory) on {args.device}")

    cfg = EraConfig(memory_bytes=args.mem_kb << 10, r_bytes=32 << 10,
                    build_impl="numpy")
    report = BuildReport(VerticalStats(), PrepareStats())
    t0 = time.perf_counter()
    idx = EraIndexer(alphabet, cfg, device=args.device).build(s, report)
    dt = time.perf_counter() - t0

    print(f"\ntotal {dt:.1f}s  ({len(s) / dt / 1e6:.2f} Msym/s)")
    print(f"  vertical partition: {report.t_vertical:.1f}s, "
          f"{report.n_prefixes} prefixes -> {report.n_groups} virtual trees "
          f"(amortization "
          f"{amortization_factor(report.n_prefixes, report.n_groups):.1f}x)")
    print(f"  elastic prepare   : {report.t_prepare:.1f}s, "
          f"{report.prepare.iterations} iterations, "
          f"{report.prepare.symbols_fetched / 1e6:.1f}M symbols fetched")
    print(f"  batch build       : {report.t_build:.1f}s, "
          f"{idx.n_leaves:,} leaves + {idx.n_internal:,} internal")

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    idx.save(args.out)
    idx2 = SuffixTreeIndex.load(args.out, alphabet, device=args.device)
    print(f"\npersisted + reloaded index ({args.out})")

    rng = np.random.default_rng(1)
    n_q = 200
    starts = rng.integers(0, len(s) - 12, size=n_q)
    pats = [s[i:i + 12] for i in starts]
    t0 = time.perf_counter()
    for i, p in zip(starts[:20], pats[:20]):  # the host walk, one at a time
        assert int(i) in idx2.find(p)
    t_walk = time.perf_counter() - t0
    t0 = time.perf_counter()
    hits = idx2.find_batch(pats)  # one batch on the device
    t_batch = time.perf_counter() - t0
    for i, h in zip(starts, hits):
        assert int(i) in h
    print(f"20 host-walk queries in {t_walk * 1e3:.0f}ms; {n_q} exact-match "
          f"queries in one device batch in {t_batch * 1e3:.0f}ms "
          f"(first batch: flattens the index)")


if __name__ == "__main__":
    main()

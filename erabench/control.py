"""The control of a cell's comparison, on the card at the cell's own size.

    python erabench/control.py --workload <cell> --seeds <n> [<n> ...] [--depth 64]

For each seed and each string of the cell's pool: the reference computed
exactly, and the control -- the same reference with its suffix order
exact only to ``--depth`` symbols, the remaining ties broken by position
-- put in the program's place and judged by the cell's own comparison.
Prints one JSON line per seed with the counts compared (each limit 0);
a control that reads 0 on any count the cell compares everywhere would
mean the comparison cannot see the broken guarantee.  The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--depth", type=int, default=64)
    args = ap.parse_args(argv)

    import torch

    from erabench import harness
    from erabench.reference import suffix_order as R
    cell = harness.find_cell(args.workload)
    base = len(cell.config["symbols"]) + 1
    f_max = R.f_max_of(int(harness.era_config(cell)["memory_bytes"]))
    dev = torch.device("cuda")
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = harness.Run(cell, pool=harness.make_strings(cell, seed))
        totals: dict = {}
        for s in run.pool:
            st = torch.from_numpy(s).to(dev)
            kept = cell.entry.control(R.index_tables(
                st, base, f_max, depth_cap=args.depth, tree=cell.entry.TREE))
            ref = R.index_tables(st, base, f_max, tree=cell.entry.TREE)
            for k, v in cell.entry.check(kept, ref).items():
                totals[k] = totals.get(k, 0) + int(v)
            del kept, ref, st
            torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "depth": args.depth, "counts": totals,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

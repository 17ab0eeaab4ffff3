"""Sharded index fabric driver — PyTorch port of
``repro.launch.shard_run``.

Builds a mesh of ``--devices`` entries round-robin over the devices of
``--device`` (``cuda``: every card, so one card runs several shards;
``cpu``: the CPU each time), then runs one of three modes:

* ``build`` — :meth:`EraIndexer.build_sharded` over the mesh, the shards'
  ``stats()`` and a probe batch through ``ShardedIndex.find_batch``;
* ``bench`` — :func:`repro_torch.core.fabric.sharded_prepare` against
  :func:`repro_torch.core.prepare.subtree_prepare_batch` at the same
  state, best of ``--repeats`` after a warm-up;
* ``save`` — ``build``, then the per-shard archives
  (``{path}_shard{k}.npz``) under ``--index-path``.

The report has the JAX driver's keys; ``mesh`` is the mesh's size and
``devices`` the distinct devices it holds, so a run that puts every shard
on one card says so.

  PYTHONPATH=src python -m repro_torch.launch.shard_run --device cpu \\
      --devices 3 --shards 3 --json
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def _parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Sharded index fabric driver: build over a mesh of "
                    "devices, optionally benchmark the sharded prepare "
                    "against the single-device batched baseline or save "
                    "the per-shard archives.")
    ap.add_argument("--devices", type=int, default=4,
                    help="mesh entries, round-robin over the devices of "
                         "--device [4]")
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand kernels) or cpu (plain PyTorch "
                         "versions) [cuda]")
    ap.add_argument("--dataset", default="dna")
    ap.add_argument("--n", type=int, default=120_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--memory-bytes", type=int, default=1 << 16)
    ap.add_argument("--shards", type=int, default=0,
                    help="index route-key shards (0 = mesh size)")
    ap.add_argument("--mode", default="build",
                    choices=["build", "bench", "save"],
                    help="build: construct + verify a ShardedIndex; "
                         "bench: time sharded vs single-device baseline; "
                         "save: build and write per-shard npz archives")
    ap.add_argument("--index-path", default=None,
                    help="archive base path for --mode save "
                         "(writes {path}_shard{k}.npz)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--sort", default=None, choices=["fused", "lexsort"],
                    help="elastic-step sort engine (REPRO_SORT): fused "
                         "single-lane keys (default) or the lexsort oracle")
    ap.add_argument("--no-compact", action="store_true",
                    help="disable tail compaction (REPRO_COMPACT=off) in "
                         "the baseline; the sharded prepare always compacts")
    # JAX's tile selection: accepted so its command lines run, without
    # effect, since the card's kernels have one launch shape (as era_run)
    ap.add_argument("--autotune", default=None,
                    choices=["off", "table", "model"],
                    help="accepted for the JAX driver's command lines; no "
                         "effect on the port")
    ap.add_argument("--autotune-table", default=None,
                    help="accepted for the JAX driver's command lines; no "
                         "effect on the port")
    ap.add_argument("--json", action="store_true",
                    help="emit one machine-readable JSON object on stdout")
    return ap.parse_args(argv)


def round_robin_mesh(n: int, device="cuda") -> list[torch.device]:
    """``n`` mesh entries over every device of ``device``'s type, in
    turn."""
    from repro_torch.core.fabric import fabric_mesh
    if n < 1:
        raise ValueError(f"--devices {n} must be >= 1")
    devices = fabric_mesh(device=device)
    return [devices[k % len(devices)] for k in range(n)]


def run(args) -> dict:
    from repro_torch.core import fabric
    from repro_torch.core.api import EraConfig, EraIndexer
    from repro_torch.core.prepare import subtree_prepare_batch
    from repro_torch.data.strings import dataset

    mesh = round_robin_mesh(args.devices, args.device)
    on_card = mesh[0].type == "cuda"
    s, alphabet = dataset(args.dataset, args.n, seed=args.seed)
    cfg = EraConfig(memory_bytes=args.memory_bytes, r_bytes=4096,
                    build_impl="none")
    ix = EraIndexer(alphabet, cfg, device=mesh[0])
    out = {
        "dataset": args.dataset, "n": args.n, "seed": args.seed,
        "memory_bytes": args.memory_bytes,
        "mesh": len(mesh), "devices": len(set(mesh)),
        "backend": mesh[0].type,
    }

    def sync():
        if on_card:
            for d in set(mesh):
                torch.cuda.synchronize(d)

    if args.mode == "bench":
        groups = ix.partition(s)
        capacity = ix._capacity(groups)
        text = ix._device_text(s)
        ecfg = cfg.elastic_config()

        def best_of(fn):
            fn()  # warm-up: the kernels' first launches
            sync()
            times = []
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                fn()
                sync()
                times.append(time.perf_counter() - t0)
            return min(times)

        t_base = best_of(
            lambda: subtree_prepare_batch(text, groups, capacity, ecfg))
        t_shard = best_of(lambda: fabric.sharded_prepare(
            text, groups, capacity, ecfg, mesh=mesh))
        out.update(groups=len(groups), capacity=capacity,
                   t_baseline_s=round(t_base, 4),
                   t_sharded_s=round(t_shard, 4),
                   speedup=round(t_base / t_shard, 3))
        return out

    n_shards = args.shards or len(mesh)
    t0 = time.perf_counter()
    sh = ix.build_sharded(s, n_shards=n_shards, mesh=mesh)
    sync()
    out["t_build_s"] = round(time.perf_counter() - t0, 4)
    out["shards"] = sh.stats()
    # a probe batch proves the routed query path end to end
    rng = np.random.default_rng(args.seed + 1)
    pats = [np.asarray(s[int(i) : int(i) + 12], np.int32)
            for i in rng.integers(0, len(s) - 13, size=16)]
    hits = sh.find_batch(pats)
    out["probe_hits"] = [int(len(h)) for h in hits]
    if args.mode == "save":
        if not args.index_path:
            raise SystemExit("--mode save needs --index-path")
        sh.save(args.index_path)
        out["archives"] = fabric.ShardedIndex.shard_files(args.index_path)
    return out


def main(argv=None):
    args = _parse_args(argv)
    # engine knobs travel through the environment, as in the JAX driver
    if args.sort is not None:
        os.environ["REPRO_SORT"] = args.sort
    if args.no_compact:
        os.environ["REPRO_COMPACT"] = "off"
    out = run(args)
    if args.json:
        print(json.dumps(out, sort_keys=True))
    else:
        for key, val in out.items():
            print(f"{key}: {val}")


if __name__ == "__main__":
    main()

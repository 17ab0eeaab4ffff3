"""Distributed ERA construction driver — PyTorch port of
``repro.launch.era_run``.

The paper's shared-memory / shared-disk parallel version (§5): a master
partitions the string into virtual trees, a fault-tolerant work queue
(:class:`repro_torch.runtime.scheduler.WorkQueue`) hands them to workers,
and each worker runs the elastic-range pipeline on its groups; there is
no merge phase, so the sub-trees of every completed group make the index.
The workers are turns of one host loop on one device, as in the JAX
driver: each turn pulls a chunk of groups and runs them through the
shared batched engine (:meth:`EraIndexer.process_groups`), and the string
is read by every worker from the one device copy.

:func:`era_prepare_batch` is the batched step itself (the alias the JAX
dry run lowers).  :func:`main` is the command line: the worker pool, or
with ``--stream`` the out-of-core single-device build.

  PYTHONPATH=src python -m repro_torch.launch.era_run --device cpu \\
      --n 20000 --workers 4
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.core.api import BuildReport, EraConfig, EraIndexer
from repro_torch.core.prepare import PrepareState, PrepareStats, prepare_step
from repro_torch.core.suffix_tree import SuffixTreeIndex
from repro_torch.core.vertical import VerticalStats
from repro_torch.data.strings import dataset
from repro_torch.runtime.scheduler import WorkQueue


def era_prepare_batch(s_text, states: PrepareState, *, w: int):
    """One elastic-range iteration for a (G, F) batch of virtual trees —
    the shared batched step (:func:`repro_torch.core.prepare.prepare_step`)
    that :meth:`EraIndexer.build` drives to convergence.  ``s_text`` is
    the terminal-padded byte string or a dense ``PackedText``; results
    are identical.  Returns (new_states, n_active[G])."""
    return prepare_step(s_text, states, w=w)


@dataclasses.dataclass
class WorkerReport:
    worker: str
    groups: int = 0
    seconds: float = 0.0


def build_distributed(
    s: np.ndarray,
    alphabet,
    era_cfg: EraConfig,
    n_workers: int = 4,
    *,
    checkpoint_path: str | None = None,
    fail_worker: str | None = None,
    fail_after: int = 1,
    groups_per_pull: int = 4,
    device="cuda",
):
    """Master/worker construction with the fault-tolerant queue
    (``repro.launch.era_run.build_distributed``), on ``device``.

    Each worker turn pulls up to ``groups_per_pull`` virtual trees and
    runs them through the shared batched (G, F) engine
    (:meth:`EraIndexer.process_groups`), then completes the tasks one by
    one, so failure and recovery stay per group.  ``fail_worker``
    simulates a node loss after ``fail_after`` completed groups: its
    in-flight work is re-queued and picked up by the survivors; when no
    worker is left, it raises.  A checkpoint's recorded groups are skipped
    by the workers, as in the JAX driver; the checkpoint holds no
    sub-trees, so they are rebuilt after the queue drains and the index
    is whole (JAX's driver returns it without them).

    Returns ``(SuffixTreeIndex, queue.stats(), [WorkerReport, ...])``.
    """
    if n_workers < 1:
        raise ValueError(f"build_distributed needs a worker, got {n_workers}")
    indexer = EraIndexer(alphabet, era_cfg, device=device)
    report = BuildReport(VerticalStats(), PrepareStats())
    groups = indexer.partition(s, report)
    capacity = indexer._capacity(groups)
    s_text = indexer._device_text(s)  # dense-packed for DNA (EraConfig.packing)

    queue = WorkQueue(checkpoint_path=checkpoint_path)
    queue.add_tasks([g.total_freq for g in groups], payloads=groups)

    workers = [f"w{i}" for i in range(n_workers)]
    dead: set[str] = set()
    completed: dict[int, list] = {}
    per_worker = {w: WorkerReport(worker=w) for w in workers}
    fail_count = 0

    while not queue.drained:
        progressed = False
        for w in workers:
            if w in dead:
                continue
            tasks = []
            while len(tasks) < max(1, groups_per_pull):
                task = queue.pull(w)
                if task is None:
                    break
                tasks.append(task)
            if not tasks:
                continue
            progressed = True
            t0 = time.perf_counter()
            results = indexer.process_groups(
                s_text, [t.payload for t in tasks], capacity)
            dt = (time.perf_counter() - t0) / len(tasks)
            for task, subtrees in zip(tasks, results):
                if w == fail_worker and fail_count >= fail_after:
                    # the node dies mid-chunk: this task and the rest of
                    # the chunk stay in flight and get re-queued
                    dead.add(w)
                    queue.mark_failed(w)
                    break
                queue.complete(task.task_id, worker=w, elapsed_s=dt)
                completed[task.task_id] = subtrees
                per_worker[w].groups += 1
                per_worker[w].seconds += dt
                if w == fail_worker:
                    fail_count += 1
        if not progressed and not queue.drained:
            if len(dead) == len(workers):
                raise RuntimeError(
                    f"every worker failed: {queue.remaining} of "
                    f"{len(groups)} groups were not built")
            # everything in flight on dead workers: force a requeue
            for w in list(dead):
                queue.mark_failed(w)

    # the groups a checkpoint recovered: done in the queue, not built here
    missing = [i for i in range(len(groups)) if i not in completed]
    pull = max(1, groups_per_pull)
    for i in range(0, len(missing), pull):
        chunk = missing[i:i + pull]
        results = indexer.process_groups(s_text, [groups[t] for t in chunk],
                                         capacity)
        completed.update(zip(chunk, results))

    subtrees = {}
    for sts in completed.values():
        for st in sts:
            subtrees[st.prefix] = st
    idx = SuffixTreeIndex(s=np.asarray(s), alphabet=alphabet,
                          subtrees=subtrees, device=indexer.device)
    return idx, queue.stats(), list(per_worker.values())


def _parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Distributed ERA construction: the fault-tolerant "
                    "worker pool, or with --stream the out-of-core build.")
    ap.add_argument("--dataset", default="dna")
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--memory-mb", type=float, default=1.0)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--batch-groups", type=int, default=4,
                    help="virtual trees per worker pull (batched engine width)")
    ap.add_argument("--stream", action="store_true",
                    help="out-of-core single-device build: double-buffered "
                         "chunk pipeline instead of the worker pool")
    ap.add_argument("--device-budget-mb", type=float, default=None,
                    help="device bytes the streaming PrepareState may "
                         "occupy (with --stream; default unbounded = one "
                         "chunk)")
    ap.add_argument("--no-overlap", action="store_true",
                    help="disable the standby-buffer copy/compute overlap "
                         "(with --stream; the synchronous baseline)")
    ap.add_argument("--sort", default=None, choices=["fused", "lexsort"],
                    help="elastic-step sort engine: fused single-lane keys "
                         "(default) or the multi-lane lexsort oracle")
    ap.add_argument("--no-compact", action="store_true",
                    help="disable tail compaction (sort every row even "
                         "after its group has converged)")
    # JAX's tile selection: accepted so its command lines run, without
    # effect, since the card's kernels have one launch shape (a sweep of
    # the block found none worth choosing: PERF.md §6, launch/block_sweep.py)
    ap.add_argument("--autotune", default=None,
                    choices=["off", "table", "model"],
                    help="accepted for the JAX driver's command lines; no "
                         "effect on the port")
    ap.add_argument("--autotune-table", default=None,
                    help="accepted for the JAX driver's command lines; no "
                         "effect on the port")
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand kernels) or cpu (plain PyTorch "
                         "versions) [cuda]")
    return ap.parse_args(argv)


def main(argv=None):
    args = _parse_args(argv)

    s, alpha = dataset(args.dataset, args.n)
    cfg = EraConfig(memory_bytes=int(args.memory_mb * (1 << 20)),
                    build_impl="none",
                    sort_fuse=(None if args.sort is None
                               else args.sort == "fused"),
                    compaction=False if args.no_compact else None)
    if args.stream:
        budget = (None if args.device_budget_mb is None
                  else int(args.device_budget_mb * (1 << 20)))
        report = BuildReport(VerticalStats(), PrepareStats())
        t0 = time.perf_counter()
        dev, sr = EraIndexer(alpha, cfg, device=args.device).build_stream(
            s, report, device_budget=budget, overlap=not args.no_overlap)
        dt = time.perf_counter() - t0
        print(f"indexed {args.n} symbols in {dt:.2f}s streaming "
              f"({sr.n_chunks} chunks, overlap={'on' if sr.overlap else 'off'})")
        print(f"stream: groups={sr.groups} iterations={sr.iterations} "
              f"copied={sr.bytes_copied / 1e6:.1f}MB "
              f"copy={sr.copy_s * 1e3:.1f}ms "
              f"hidden={sr.copy_hidden_s * 1e3:.1f}ms "
              f"(overlap_frac={sr.overlap_frac:.2f})")
        print(f"leaves={dev.n_leaves} subtrees={dev.n_subtrees}")
        return
    t0 = time.perf_counter()
    idx, qstats, workers = build_distributed(
        s, alpha, cfg, n_workers=args.workers, checkpoint_path=args.checkpoint,
        groups_per_pull=args.batch_groups, device=args.device)
    dt = time.perf_counter() - t0
    print(f"indexed {args.n} symbols in {dt:.2f}s with {args.workers} workers")
    print(f"queue: {qstats}")
    for w in workers:
        print(f"  {w.worker}: {w.groups} groups, {w.seconds:.2f}s")
    print(f"leaves={idx.n_leaves} subtrees={len(idx.subtrees)}")


if __name__ == "__main__":
    main()

"""Where the out-of-core stream build spends its time, on the card.

  python -m repro_torch.launch.stream_bench               # genome, n = 2**27
  python -m repro_torch.launch.stream_bench --dataset protein

The partition and the device text are built once, with the default
``EraConfig`` and a device budget of G x ``state_bytes_per_group(F)`` // 8
(the smoke's).  Then, in turns (slice, scatter, scatter, slice), phase
``stream``: ``subtree_prepare_stream`` with its chunk states built by
``_host_init_batch`` (a slice write per prefix, the shipped design) and
with the same states built by ``prepare._init_arrays`` on the host (the
one-scatter-per-field build the device init uses) and then pinned, the
design measured first; each run's seconds, the seconds spent building
chunk states, and its result held equal to the one-shot's (``start``
aside, a schedule cursor).  Phase ``one_shot``: ``subtree_prepare_batch``.
Phase ``peaks``: ``max_memory_allocated`` around each prepare stage
alone (reset after the partition and the text) in this fresh process.
Phase ``drain``: one chunk's six fields copied into a slice of the
pageable host output and into pinned memory, and the time to pin them.

Each result is one JSON line; the card's ``nvidia-smi`` name and power
limit come first.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from repro_torch.core import iomodel, prepare
from repro_torch.core.api import EraConfig, EraIndexer
from repro_torch.core.prepare import PrepareState
from repro_torch.data.strings import dataset

RESULT_FIELDS = ("L", "area", "b_off", "b_c1", "b_c2")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def scatter_host_init(groups, capacity: int, pin: bool = False):
    """The chunk state built on the host by ``prepare._init_arrays`` (one
    scatter per field through ``repeat_interleave``), then pinned."""
    cpu = torch.device("cpu")
    L, start, area = prepare._init_arrays(groups, capacity, cpu)
    state = PrepareState(L, start, area,
                         torch.full(L.shape, -1, dtype=torch.int32),
                         torch.zeros(L.shape, dtype=torch.int32),
                         torch.zeros(L.shape, dtype=torch.int32))
    return PrepareState(*(t.pin_memory() for t in state)) if pin else state


def timed_stream(text, groups, cap, ecfg, budget, build) -> tuple:
    """``subtree_prepare_stream`` with ``build`` making the chunk states:
    (state, report, seconds, seconds building chunk states)."""
    spent = [0.0]

    def host_init(*args, **kw):
        t = time.perf_counter()
        out = build(*args, **kw)
        spent[0] += time.perf_counter() - t
        return out

    shipped = prepare._host_init_batch
    prepare._host_init_batch = host_init
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, rep = prepare.subtree_prepare_stream(
            text, groups, cap, ecfg, device_budget=budget)
        return state, rep, time.perf_counter() - t0, spent[0]
    finally:
        prepare._host_init_batch = shipped


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-log2", type=int, default=27)
    ap.add_argument("--dataset", default="genome")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stream_bench: no CUDA device available", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    s, alpha = dataset(args.dataset, 1 << args.n_log2, seed=0)
    ix = EraIndexer(alpha, EraConfig())
    groups = ix.partition(s)
    cap = ix._capacity(groups)
    text = ix._device_text(s)
    ecfg = ix.config.elastic_config()
    budget = len(groups) * iomodel.state_bytes_per_group(cap) // 8
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    want = prepare.subtree_prepare_batch(text, groups, cap, ecfg)
    torch.cuda.synchronize()
    t_one = time.perf_counter() - t0
    peak_one = torch.cuda.max_memory_allocated()
    want = PrepareState(*(t.cpu() for t in want))
    emit({"phase": "one_shot", "dataset": args.dataset,
          "n": len(s) - 1, "groups": len(groups), "capacity": cap,
          "t_prepare_s": t_one})

    designs = {"slice": prepare._host_init_batch, "scatter": scatter_host_init}
    peak_stream = None
    for name in ("slice", "scatter", "scatter", "slice"):
        torch.cuda.reset_peak_memory_stats()
        got, rep, t, t_init = timed_stream(text, groups, cap, ecfg, budget,
                                           designs[name])
        peak_stream = peak_stream or torch.cuda.max_memory_allocated()
        for field in RESULT_FIELDS:
            if not torch.equal(getattr(want, field), getattr(got, field)):
                raise AssertionError(f"{name}: {field} differs from the "
                                     f"one-shot prepare")
        emit({"phase": "stream", "host_init": name, "t_prepare_s": t,
              "t_host_init_s": t_init, "vs_one_shot": t / t_one,
              "n_chunks": rep.n_chunks, "iterations": rep.iterations,
              "overlap_frac": rep.overlap_frac, "copy_s": rep.copy_s,
              "copy_wait_s": rep.copy_wait_s, "equal_to_one_shot": True})
        del got
    emit({"phase": "peaks", "resident_before": resident,
          "one_shot_max_memory_allocated": peak_one,
          "stream_max_memory_allocated": peak_stream,
          "ratio": peak_stream / peak_one})

    gpc = iomodel.plan_stream(len(groups), cap,
                              budget_bytes=budget).groups_per_chunk
    chunk = prepare.init_batch(groups[:gpc], cap, text.device)
    out = torch.empty((len(groups), cap), dtype=torch.int32)
    t0 = time.perf_counter()
    pinned = [torch.empty((gpc, cap), dtype=torch.int32, pin_memory=True)
              for _ in chunk]
    t_pin = time.perf_counter() - t0
    times = {}
    for name, dst in (("pageable_ms", lambda i: out[:gpc]),
                      ("pinned_ms", lambda i: pinned[i])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, d in enumerate(chunk):
            dst(i).copy_(d)
        times[name] = (time.perf_counter() - t0) * 1e3
    emit({"phase": "drain", "groups": gpc,
          "bytes": sum(t.numel() * 4 for t in chunk), **times,
          "pin_alloc_ms": t_pin * 1e3})
    return 0


if __name__ == "__main__":
    sys.exit(main())

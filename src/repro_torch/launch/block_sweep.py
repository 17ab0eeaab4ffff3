"""Time the five build kernels that a Pallas tile sizes at every block of
threads, at the main path's shapes.

  python -m repro_torch.launch.block_sweep            # n = 2**27

The port launches ``range_gather_words``, ``range_gather_pack``,
``range_gather_packed``, ``suffix_lcp_words`` and ``suffix_lcp_pairs`` at
256 threads a block, where JAX picks the TPU kernels' ``tile`` per shape
from its autotune table.  This sweep is what keeps them at one shape:
each source is compiled again at 128, 256, 512 and 1024 threads
(``-DERA_BLOCK_THREADS``), and each wrapper launches, in turn, each
build's entry point in place of its own (the same C interface).

The shapes are the main path's: the genome and protein indexes' ``ell``
at n = 2**N (``build_device``) read at w = 4 (``range_gather_words`` and
``range_gather_packed`` on the genome's dense text, ``range_gather_pack``
on the protein byte string), and their adjacent ``ell`` pairs at w = 64
(the node build's text LCPs).  Every block's output must equal the
package's kernel's; then the blocks are timed in turns (128 … 1024, 1024
… 128) as one-launch CUDA-event windows and as the profiler's kernel
time (:func:`gather_bench.in_turns`: a session that missed a launch is
not counted, and a block none of whose sessions recorded every launch
reads null).

One JSON line per kernel; the card's ``nvidia-smi`` name and power limit
come first.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.core.api import EraConfig, EraIndexer
from repro_torch.data.strings import dataset
from repro_torch.kernels import _build
from repro_torch.kernels import ops
from repro_torch.launch.gather_bench import _emit, compile_baseline, in_turns

BLOCKS = (128, 256, 512, 1024)
KERNELS = ("range_gather_words", "range_gather_pack", "range_gather_packed",
           "suffix_lcp_words", "suffix_lcp_pairs")


@contextlib.contextmanager
def entry_from(name: str, lib):
    """``ops``'s ``name`` launching ``lib``'s entry point of that name (the
    same C interface) inside the block."""
    cur = _build._ENTRIES[name]
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = cur.argtypes, cur.restype
    _build._ENTRIES[name] = fn
    try:
        yield
    finally:
        _build._ENTRIES[name] = cur


def main_path_calls(n_log2: int) -> dict:
    """{kernel: (shape, call)} at the main path's shapes."""
    cfg = EraConfig()
    out = {}
    for name in ("genome", "protein"):
        s, alpha = dataset(name, 1 << n_log2, seed=0)
        indexer = EraIndexer(alpha, cfg)
        ell = indexer.build_device(s).ell
        pa, pb = ell[:-1].contiguous(), ell[1:].contiguous()
        rows, pairs = f"rows={ell.shape[0]} w=4", f"rows={pa.shape[0]} w=64"
        if name == "genome":
            pt = indexer._device_text(s)  # dense words
            out["range_gather_words"] = (rows, lambda pt=pt, o=ell: ops.KERNELS[
                "range_gather_words"](pt, o, 4))
            out["range_gather_packed"] = (
                f"{rows} (the genome's dense text)",
                lambda pt=pt, o=ell: ops.KERNELS["range_gather_packed"](pt, o,
                                                                        4))
            out["suffix_lcp_words"] = (
                f"{pairs} (adjacent ell pairs)",
                lambda pt=pt, a=pa, b=pb: ops.KERNELS["suffix_lcp_words"](
                    pt, a, b, 64))
        else:
            sp = indexer._pad(s)  # the terminal-padded byte string
            out["range_gather_pack"] = (rows, lambda sp=sp, o=ell: ops.KERNELS[
                "range_gather_pack"](sp, o, 4))
            out["suffix_lcp_pairs"] = (
                f"{pairs} (adjacent ell pairs)",
                lambda sp=sp, a=pa, b=pb: ops.KERNELS["suffix_lcp_pairs"](
                    sp, a, b, 64))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-log2", type=int, default=27)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("block_sweep: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    _emit({"phase": "device", "nvidia_smi": smi,
           "name": torch.cuda.get_device_name(0)})
    _build.build_all()
    with ThreadPoolExecutor(len(BLOCKS)) as pool:  # every nvcc at once
        libs = dict(zip(BLOCKS, pool.map(
            lambda b: compile_baseline(_build.CSRC, KERNELS,
                                       flags=(f"-DERA_BLOCK_THREADS={b}",)),
            BLOCKS)))
    for kernel, (shape, call) in main_path_calls(args.n_log2).items():
        want = call()  # the package's kernel, 256 threads a block

        def at(b, kernel=kernel, call=call):
            with entry_from(kernel, libs[b][kernel]):
                return call()

        calls = {b: (lambda b=b: at(b)) for b in BLOCKS}
        for b, fn in calls.items():
            if not torch.equal(fn(), want):
                raise AssertionError(f"{kernel} at {b} threads differs")
        del want
        event = in_turns(calls)
        device = in_turns(calls, device=True, key=kernel)
        timed = {b: ms for b, ms in device.items() if ms is not None}
        best_event = min(event, key=lambda b: (event[b], b))
        best_device = (min(timed, key=lambda b: (timed[b], b)) if timed
                       else None)
        _emit({"phase": "block_sweep", "kernel": kernel, "shape": shape,
               "event_ms": event, "device_ms": device,
               "best_event": best_event, "best_device": best_device,
               "default_vs_best_event": event[256] / event[best_event],
               "default_vs_best_device": (
                   device[256] / timed[best_device]
                   if best_device and device[256] else None)})
        torch.cuda.empty_cache()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

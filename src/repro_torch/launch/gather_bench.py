"""Time the three elastic-range gathers on the card, optionally beside an
earlier version of their CUDA sources.

  python -m repro_torch.launch.gather_bench                 # n = 2**27
  python -m repro_torch.launch.gather_bench --baseline DIR  # A/B

The genome and protein indexes are built at n = 2**N (``build_device``)
for the main-path offsets: ``ell``, every suffix in suffix-array order,
read at w = 4 (the first elastic step).  Then, with CUDA events:

* ``range_gather_words`` on the dense DNA text and ``range_gather_pack``
  on the protein string, at the main-path shape, on ``ell`` sorted
  ascending, and at the parity shapes (2**20 random offsets, w = 4 …
  256), as CUDA-event windows (``ms``) and as the profiler's kernel time
  (``device_ms``, which a small launch's host time does not inflate);
  at the main-path shape also under a persisting L2 window over
  the text (:func:`persisting_l2_window`; no kernel of the port sets
  one);
* ``range_gather_packed`` (the ``REPRO_WORD_COMPARE=byte`` leg's read) on
  the dense DNA text at n = 2**min(N, 25), the byte leg's size: on its
  ``ell`` (the leg's order), on ``ell`` sorted and on 2**20 random
  offsets, at w = 4, 16, 64 and 256, without and with a row mask (half
  the rows on), event and profiler time alike;
* with ``--baseline DIR``: the same calls through the kernels built from
  whichever of ``DIR/range_gather_words.cu``, ``DIR/range_gather_pack.cu``
  and ``DIR/range_gather_packed.cu`` it holds (C entry points without the
  mask argument: the mask is a ``torch.where`` after the launch, as
  before it was fused; ``src/repro_torch/kernels/baseline`` holds the
  earlier ``range_gather_packed.cu``), in turns with the current ones
  (current, baseline, baseline, current), their outputs held equal; then
  one warm ``build_device`` per dataset under the profiler with the
  current gathers and with the baseline ones, in the same turns, their
  ``ell`` held equal (genome and protein for the first two, the byte leg
  for the third).

Each result is one JSON line; the card's ``nvidia-smi`` name and power
limit come first.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.api import BuildReport, EraConfig, EraIndexer
from repro_torch.core.packing import _sub_word, pack_text
from repro_torch.core.prepare import PrepareStats
from repro_torch.core.vertical import VerticalStats
from repro_torch.data.strings import dataset
from repro_torch.kernels import _build
from repro_torch.kernels import ops

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_U32 = ctypes.c_uint
BYTE_LEG_LOG2 = 25  # the REPRO_WORD_COMPARE=byte leg's n, as in the smoke


def l2_window_state(stream: torch.cuda.Stream | None = None) -> tuple[int, int]:
    """(bytes of the access-policy window ``stream`` holds, bytes of the
    device's persisting L2 set-aside) right now."""
    stream = stream or torch.cuda.current_stream()
    fn = _build.entry("l2_window", [_P, _P, _P], symbol="l2_window_state")
    win, lim = ctypes.c_longlong(0), ctypes.c_longlong(0)
    _build.check(fn(_P(stream.cuda_stream), ctypes.addressof(win),
                    ctypes.addressof(lim)), "l2_window_state")
    return win.value, lim.value


@contextlib.contextmanager
def persisting_l2_window(t: torch.Tensor):
    """A persisting L2 window over ``t``'s bytes on the current stream for
    the launches inside the block (``csrc/l2_window.cu``); on exit the
    stream's window, the device's persisting limit and the lines marked
    persisting go back to what they were.  Yields the hit ratio used."""
    stream = torch.cuda.current_stream()
    set_fn = _build.entry("l2_window", [_P, _P, _I64, _P],
                          symbol="l2_window_set")
    clear_fn = _build.entry("l2_window", [_P], symbol="l2_window_clear")
    ratio = ctypes.c_float(0.0)
    _build.check(set_fn(_P(stream.cuda_stream), t.data_ptr(),
                        t.numel() * t.element_size(),
                        ctypes.addressof(ratio)), "l2_window_set")
    try:
        yield ratio.value
    finally:
        _build.check(clear_fn(_P(stream.cuda_stream)), "l2_window_clear")


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _ms(fn, reps: int = 5) -> list[float]:
    """Milliseconds of each of ``reps`` calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def _device_ms(fn, reps: int = 20, key: str = "range_gather") -> float:
    """Device milliseconds per call of the kernels named ``key`` that
    ``fn`` launches, from ``torch.profiler`` (kernel time only: a small
    launch's event window also holds the host's time to launch it)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0)
             for e in prof.key_averages() if key in e.key)
    return us / 1e3 / reps


def in_turns(calls: dict, reps: int = 5, device: bool = False,
             key: str = "range_gather") -> dict:
    """Median ms of each call, timed in turns A, B, …, …, B, A: CUDA-event
    windows, or with ``device`` the profiler's kernel time (of the
    kernels named ``key``)."""
    order = list(calls) + list(reversed(calls))
    times = {k: [] for k in calls}
    for k in order:
        times[k] += ([_device_ms(calls[k], key=key)] if device
                     else _ms(calls[k], reps))
    return {k: float(np.median(v)) for k, v in times.items()}


def compile_baseline(src: Path, names) -> dict[str, ctypes.CDLL]:
    """``src/<name>.cu`` for each name compiled (headers found in ``src``
    first, then in the package's csrc/), one ``nvcc`` each, loaded with
    ctypes."""
    h = hashlib.sha256()
    for p in sorted(src.iterdir()):
        h.update(p.name.encode() + p.read_bytes())
    out = _build.BUILD_ROOT.parent / "baseline" / h.hexdigest()[:16]
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = out / f"{name}.so"
        if not lib.exists():
            procs[name] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src), "-I",
                 str(_build.CSRC), "-o", str(lib), str(src / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"baseline {name}.cu failed to build:\n{log}")
    return {n: ctypes.CDLL(str(out / f"{n}.so")) for n in names}


BASELINE_ARGS = {  # the earlier C entry points: no mask argument
    "range_gather_words": [_P, _I64, _P, _I64, _I32, _I32, _I64, _U32, _P,
                           _P],
    "range_gather_pack": [_P, _I64, _P, _I64, _I32, _P, _P],
    "range_gather_packed": [_P, _I64, _P, _I64, _I32, _I32, _I64, _U32, _P,
                            _P],
}


def build_baseline(src: Path) -> dict[str, ctypes.CDLL]:
    """The gathers whose sources ``src`` holds, compiled, entry points
    typed."""
    names = [n for n in BASELINE_ARGS if (src / f"{n}.cu").exists()]
    if not names:
        raise FileNotFoundError(f"{src} holds none of "
                                f"{', '.join(BASELINE_ARGS)} (.cu)")
    libs = compile_baseline(src, names)
    for name, lib in libs.items():
        getattr(lib, name).argtypes = BASELINE_ARGS[name]
        getattr(lib, name).restype = _I32
    return libs


def baseline_words(lib, pt, offs, w):
    nw = -(-w // pt.syms_per_word)
    out = torch.empty((offs.shape[0], nw), dtype=torch.int32,
                      device=offs.device)
    rc = lib.range_gather_words(
        pt.words.data_ptr(), pt.words.shape[0], offs.data_ptr(),
        offs.shape[0], nw, pt.bits, pt.n_real,
        _sub_word(pt.bits, pt.terminal), out.data_ptr(),
        _P(torch.cuda.current_stream().cuda_stream))
    _build.check(rc, "baseline range_gather_words")
    return out


def baseline_pack(lib, sp, offs, w):
    out = torch.empty((offs.shape[0], w // 4), dtype=torch.int32,
                      device=offs.device)
    rc = lib.range_gather_pack(
        sp.data_ptr(), sp.shape[0], offs.data_ptr(), offs.shape[0], w // 4,
        out.data_ptr(), _P(torch.cuda.current_stream().cuda_stream))
    _build.check(rc, "baseline range_gather_pack")
    return out


def baseline_packed(lib, pt, offs, w):
    out = torch.empty((offs.shape[0], w // 4), dtype=torch.int32,
                      device=offs.device)
    rc = lib.range_gather_packed(
        pt.words.data_ptr(), pt.words.shape[0], offs.data_ptr(),
        offs.shape[0], w // 4, pt.bits, pt.n_real,
        (pt.terminal & 0xFF) * 0x01010101, out.data_ptr(),
        _P(torch.cuda.current_stream().cuda_stream))
    _build.check(rc, "baseline range_gather_packed")
    return out


BASELINE_CALLS = {"range_gather_words": baseline_words,
                  "range_gather_pack": baseline_pack,
                  "range_gather_packed": baseline_packed}


def masked(keys, mask):
    """The row mask as a ``torch.where`` after an earlier kernel."""
    return keys if mask is None else torch.where(mask[:, None], keys, 0)


@contextlib.contextmanager
def baseline_gathers(base: dict):
    """Each ``ops`` gather that ``base`` holds swapped for its baseline
    kernel, the row mask applied by a ``torch.where`` after the launch."""
    saved = {k: getattr(ops, k) for k in base}
    for k, lib in base.items():
        setattr(ops, k, lambda t, offs, w, mask=None, k=k, lib=lib: masked(
            BASELINE_CALLS[k](lib, t, offs, w), mask))
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(ops, k, fn)


def profiled_build(s, alpha) -> tuple[dict, np.ndarray]:
    """One ``build_device`` under the profiler: its seconds, the gather
    kernels' device ms, all device ms; and its ``ell``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    report = BuildReport(VerticalStats(), PrepareStats())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dev = EraIndexer(alpha, EraConfig()).build_device(s, report)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ell = dev.ell.cpu().numpy()
    del dev
    torch.cuda.empty_cache()
    dev_rows = [e for e in prof.key_averages()
                if getattr(e, "device_type", DeviceType.CUDA) != DeviceType.CPU]
    ms = lambda rows: sum(getattr(e, "self_device_time_total", 0)
                          for e in rows) / 1e3
    return {"t_total_s": wall, "t_prepare_s": report.t_prepare,
            "gathers_ms": ms([e for e in dev_rows
                              if "range_gather" in e.key]),
            "device_ms": ms(dev_rows)}, ell


@contextlib.contextmanager
def word_compare(leg: str | None):
    """``REPRO_WORD_COMPARE`` set to ``leg`` (None: left as it is) inside
    the block."""
    saved = os.environ.get("REPRO_WORD_COMPARE")
    if leg is not None:
        os.environ["REPRO_WORD_COMPARE"] = leg
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("REPRO_WORD_COMPARE", None)
        else:
            os.environ["REPRO_WORD_COMPARE"] = saved


# (dataset, REPRO_WORD_COMPARE leg, the gather its build runs)
BUILDS = (("genome", None, "range_gather_words"),
          ("protein", None, "range_gather_pack"),
          ("genome", "byte", "range_gather_packed"))


def build_ab(n_log2: int, base: dict) -> None:
    """Profiled warm builds with the current and the baseline gathers, in
    turns current, baseline, baseline, current, per dataset whose gather
    ``base`` holds (the byte leg at its own n)."""
    for name, leg, kernel in BUILDS:
        if kernel not in base:
            continue
        n = 1 << (min(n_log2, BYTE_LEG_LOG2) if leg else n_log2)
        s, alpha = dataset(name, n, seed=0)
        with word_compare(leg):
            EraIndexer(alpha, EraConfig()).build_device(s)  # warm-up
            runs = {"current": [], "baseline": []}
            ells = {}
            for who in ("current", "baseline", "baseline", "current"):
                with (baseline_gathers({kernel: base[kernel]})
                      if who == "baseline" else contextlib.nullcontext()):
                    row, ells[who] = profiled_build(s, alpha)
                runs[who].append(row)
        if not np.array_equal(ells["current"], ells["baseline"]):
            raise AssertionError(f"{name}: the builds' ell disagree")
        _emit({"phase": "build_ab", "dataset": name, "leg": leg or "word",
               "kernel": kernel, "n": n,
               **{f"{who}_{k}": float(np.median([r[k] for r in rs]))
                  for who, rs in runs.items() for k in rs[0]},
               "runs": runs})


def cases(n_log2: int, rng) -> list[tuple]:
    """(kernel, shape name, text, offsets, w, mask) of every timing."""
    cfg = EraConfig()
    n = 1 << n_log2
    out = []
    for name, kernel in (("genome", "range_gather_words"),
                         ("protein", "range_gather_pack")):
        s, alpha = dataset(name, n, seed=0)
        dev = EraIndexer(alpha, cfg).build_device(s)
        ell = dev.ell
        del dev
        if kernel == "range_gather_words":
            text = pack_text(s, alpha, extra=2 * cfg.w_max + 8, device="cuda")
            hi = text.n_real
        else:
            text = EraIndexer(alpha, cfg)._pad(s)
            hi = len(s) - 1
        out.append((kernel, f"main rows={ell.shape[0]} w=4", text, ell, 4,
                    None))
        out.append((kernel, f"sorted rows={ell.shape[0]} w=4", text,
                    torch.sort(ell).values, 4, None))
        rand = torch.from_numpy(rng.integers(0, hi + 1, size=1 << 20)
                                .astype(np.int32)).cuda()
        for w in (4, 8, 16, 32, 64, 128, 256):
            out.append((kernel, f"parity rows={1 << 20} w={w}", text, rand, w,
                        None))
    # range_gather_packed: the byte leg's text and ell (the same suffix
    # array as the word leg's build)
    s, alpha = dataset("genome", 1 << min(n_log2, BYTE_LEG_LOG2), seed=0)
    ell = EraIndexer(alpha, cfg).build_device(s).ell
    text = pack_text(s, alpha, extra=2 * cfg.w_max + 8, device="cuda")
    rand = torch.from_numpy(rng.integers(0, text.n_real + 1, size=1 << 20)
                            .astype(np.int32)).cuda()
    for order, offs in (("main", ell), ("sorted", torch.sort(ell).values),
                        ("random", rand)):
        half = torch.from_numpy(rng.random(offs.shape[0]) < 0.5).cuda()
        for w in (4, 16, 64, 256):
            for mask in (None, half):
                out.append(("range_gather_packed",
                            f"{order} rows={offs.shape[0]} w={w} mask="
                            f"{'off' if mask is None else 'half'}",
                            text, offs, w, mask))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-log2", type=int, default=27)
    ap.add_argument("--baseline", type=Path, default=None,
                    help="directory of earlier range_gather_words.cu, "
                         "range_gather_pack.cu or range_gather_packed.cu to "
                         "time beside these")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gather_bench: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    _emit({"phase": "device", "nvidia_smi": smi,
           "name": torch.cuda.get_device_name(0)})
    _build.build_all()
    base = build_baseline(args.baseline) if args.baseline else None
    rng = np.random.default_rng(3)
    for kernel, shape, text, offs, w, mask in cases(args.n_log2, rng):
        fn = getattr(ops, kernel)
        calls = {"ms": lambda: fn(text, offs, w, mask=mask)}
        extra = {}
        if shape.startswith("main") and kernel != "range_gather_packed":
            words = text.words if kernel == "range_gather_words" else text
            with persisting_l2_window(words) as ratio:
                extra = {"l2_window_ms": in_turns(calls)["ms"],
                         "l2_window_hit_ratio": ratio}
        if base is not None and kernel in base:
            b_fn, lib = BASELINE_CALLS[kernel], base[kernel]
            calls["baseline_ms"] = lambda: masked(b_fn(lib, text, offs, w),
                                                  mask)
            if not torch.equal(calls["ms"](), calls["baseline_ms"]()):
                raise AssertionError(f"{kernel} {shape}: the kernel and the "
                                     f"baseline disagree")
        # the profiler's time of the gather kernels alone (a baseline's
        # torch.where is in its event time only)
        device = {f"device_{k}": v for k, v in
                  in_turns(calls, device=True, key=kernel).items()}
        _emit({"phase": "gather_bench", "kernel": kernel, "shape": shape,
               **in_turns(calls), **device, **extra})
    if base is not None:
        build_ab(args.n_log2, base)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

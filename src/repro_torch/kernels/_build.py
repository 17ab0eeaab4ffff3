"""Build and load the port's CUDA kernels (nvcc + ctypes).

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with :mod:`ctypes`.  The
build runs at first use — one ``nvcc`` per source, all started together —
into ``build/kernels/<hash>/`` at the root of the checkout, keyed on a
hash of the sources and flags, so a fresh checkout builds everything on
its first kernel call and later processes reuse the libraries.  A missing
``nvcc`` or a failed build raises; nothing falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
SOURCES = ("range_gather_words", "pattern_probe_words", "kmer_histogram",
           "range_gather_pack", "lcp_pairs", "pattern_probe",
           "pattern_probe_packed", "range_gather_packed", "suffix_lcp_words",
           "suffix_lcp_pairs", "probe_gather_words", "probe_gather_packed",
           "flash_attention", "flash_attention_sm90", "search_bounds_words",
           "search_bounds_bytes", "search_fetch_words", "search_fetch_bytes",
           "l2_window", "dram_latency")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_ENTRIES: dict[str, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError(
            "nvcc not found: the repro_torch CUDA kernels are compiled at "
            "first use and need the CUDA toolkit")
    return found


def build_dir() -> Path:
    """The directory keyed on a hash of every source and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, float]:
    """Compile every missing library, all ``nvcc`` processes at once.

    Returns the wall seconds each compile took (0.0 for libraries already
    built).  The compiler's ``-Xptxas -v`` report lands beside each
    library as ``<name>.log``.
    """
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SOURCES if not (out / f"{n}.so").exists()]
    secs = {n: 0.0 for n in SOURCES}
    if not todo:
        return secs
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    try:
        for name in todo:
            tmp = out / f"{name}.so.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp)
        failed = []
        for name, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            secs[name] = time.perf_counter() - t0
            (out / f"{name}.log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out / f"{name}.so")  # atomic for parallel builders
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return secs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source (building all at first use)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(build_dir() / f"{name}.so"))
            _LIBS[name] = lib
        return lib


def entry(name: str, argtypes: list, symbol: str | None = None):
    """The C entry point ``symbol`` (default ``name``) of library ``name``,
    its signature set once (``c_void_p`` pointers and stream, sized
    integers) and cached."""
    symbol = symbol or name
    fn = _ENTRIES.get(symbol)
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _ENTRIES[symbol] = fn
    return fn


def check(rc: int, kernel: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {rc}")

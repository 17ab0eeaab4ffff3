"""Wrapper of the k-mer histogram CUDA kernel (vertical-partition counting).

:func:`kmer_histogram` runs ``csrc/kmer_histogram.cu``, the port of
``repro/kernels/kmer_histogram.py:kmer_histogram``, for CUDA tensors and
the plain ``bincount`` version (:func:`repro_torch.kernels.ref.kmer_histogram_ref`)
for CPU tensors.  Launches are counted in ``kmer_histogram.launches``; the
path of the last launch (shared-memory or global histogram) is kept in
``kmer_histogram.last_used_smem``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.packed_gather import _on_cpu, _require, _stream

MAX_BINS = 1 << 16  # the TPU kernel's VMEM bound, kept as the contract


def kmer_histogram(s: torch.Tensor, n: int, k: int, base: int) -> torch.Tensor:
    """int32[base**k] counts of the base-``base`` codes of the length-``k``
    windows starting at ``0..n-1``.  ``s``: uint8 codes ``< base``, at
    least ``n + k - 1`` of them."""
    nbins = base**k
    if nbins > MAX_BINS:
        raise ValueError(f"{nbins} bins exceed the kernel's {MAX_BINS}")
    if s.shape[0] < n + k - 1:
        raise ValueError(f"kmer_histogram reads {n + k - 1} symbols, "
                         f"s holds {s.shape[0]}")
    if _on_cpu(s):
        return _ref.kmer_histogram_ref(s, n, k, base)
    _require(s, "s", torch.uint8, 1)
    out = torch.empty(nbins, dtype=torch.int32, device=s.device)
    if n <= 0:
        return out.zero_()
    fn = _build.entry("kmer_histogram",
                      [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    used = ctypes.c_int(0)
    with torch.cuda.device(s.device):
        rc = fn(s.data_ptr(), n, k, base, nbins, out.data_ptr(),
                ctypes.byref(used), _stream(s.device))
    _build.check(rc, "kmer_histogram")
    kmer_histogram.launches += 1
    kmer_histogram.last_used_smem = bool(used.value)
    return out


kmer_histogram.launches = 0
kmer_histogram.last_used_smem = None

"""Wrapper of the k-mer histogram CUDA kernel (vertical-partition counting).

:func:`kmer_histogram` runs ``csrc/kmer_histogram.cu``, the port of
``repro/kernels/kmer_histogram.py:kmer_histogram``, for CUDA tensors and
the plain ``bincount`` version (:func:`repro_torch.kernels.ref.kmer_histogram_ref`)
for CPU tensors.  :func:`plan` picks the kernel's histogram layout from the
bin count; launches are counted in ``kmer_histogram.launches`` and the
layout of the last launch is kept in ``kmer_histogram.last_path``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.packed_gather import _on_cpu, _require, _stream

MAX_BINS = 1 << 16  # the TPU kernel's VMEM bound, kept as the contract
THREADS = 1024  # threads per block of every layout
WARP_COPY_BYTES = 64 * 1024  # the warp copies of a block, at most
H100_SMEM_OPTIN = 232_448  # shared memory a Hopper block can opt into
PATHS = ("warp_copies", "block", "cluster")
_I32 = ctypes.c_int


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of the kernel: its histogram layout (``path``), the shared
    memory of each block of ``THREADS`` threads, the blocks of a cluster
    (1 outside ``"cluster"``) and the log2 of the bins each block of a
    cluster owns."""

    path: str
    smem: int
    cluster: int
    share_log2: int


def plan(nbins: int, smem_optin: int = H100_SMEM_OPTIN) -> Plan:
    """The layout for ``nbins`` bins: a copy per warp while the block's
    copies fit in ``WARP_COPY_BYTES``; else one histogram per block while
    it fits in the opt-in shared memory; else a cluster of 2 (or 4)
    blocks, each owning a power-of-two share of the bins."""
    if not 2 <= nbins <= MAX_BINS:
        raise ValueError(f"{nbins} bins: the kernel counts 2..{MAX_BINS}")
    copies = THREADS // 32 * nbins * 4
    if copies <= WARP_COPY_BYTES:
        return Plan("warp_copies", copies, 1, 0)
    if nbins * 4 <= smem_optin:
        return Plan("block", nbins * 4, 1, 0)
    for cluster in (2, 4):
        share_log2 = (-(-nbins // cluster) - 1).bit_length()
        if 4 << share_log2 <= smem_optin:
            return Plan("cluster", 4 << share_log2, cluster, share_log2)
    raise ValueError(f"{nbins} bins fit no layout in {smem_optin} bytes")


_DEVICES: dict[int, tuple[int, int]] = {}


def device_limits(device: torch.device) -> tuple[int, int]:
    """(SM count, opt-in shared memory per block) of a card, cached."""
    fn = _build.entry("kmer_histogram", [_I32, ctypes.c_void_p,
                                         ctypes.c_void_p],
                      symbol="kmer_histogram_device")
    idx = (device.index if device.index is not None
           else torch.cuda.current_device())
    if idx not in _DEVICES:
        sms, smem = _I32(0), _I32(0)
        _build.check(fn(idx, ctypes.byref(sms), ctypes.byref(smem)),
                     "kmer_histogram_device")
        _DEVICES[idx] = (sms.value, smem.value)
    return _DEVICES[idx]


def kmer_histogram(s: torch.Tensor, n: int, k: int, base: int,
                   layout: Plan | None = None) -> torch.Tensor:
    """int32[base**k] counts of the base-``base`` codes of the length-``k``
    windows starting at ``0..n-1``.  ``s``: uint8 codes ``< base``, at
    least ``n + k - 1`` of them.  ``layout`` overrides :func:`plan` (a
    bench's A/B of two layouts)."""
    nbins = base**k
    if nbins > MAX_BINS:
        raise ValueError(f"{nbins} bins exceed the kernel's {MAX_BINS}")
    if s.shape[0] < n + k - 1:
        raise ValueError(f"kmer_histogram reads {n + k - 1} symbols, "
                         f"s holds {s.shape[0]}")
    if _on_cpu(s):
        return _ref.kmer_histogram_ref(s, n, k, base)
    _require(s, "s", torch.uint8, 1)
    sms, smem_optin = device_limits(s.device)
    p = layout or plan(nbins, smem_optin)
    out = torch.empty(nbins, dtype=torch.int32, device=s.device)
    if n <= 0:
        return out.zero_()
    fn = _build.entry("kmer_histogram",
                      [ctypes.c_void_p, ctypes.c_longlong] + [_I32] * 8
                      + [ctypes.c_void_p, ctypes.c_void_p])
    with torch.cuda.device(s.device):
        rc = fn(s.data_ptr(), n, k, base, nbins, PATHS.index(p.path),
                p.smem, p.cluster, p.share_log2, sms,
                out.data_ptr(), _stream(s.device))
    _build.check(rc, "kmer_histogram")
    kmer_histogram.launches += 1
    kmer_histogram.last_path = p.path
    return out


kmer_histogram.launches = 0
kmer_histogram.last_path = None

"""Wrapper of the dense text packing CUDA kernel.

:func:`pack_text_dense` runs ``csrc/pack_text_dense.cu`` for a CUDA tensor
and the plain version (:func:`repro_torch.kernels.ref.pack_text_dense_ref`)
for a CPU tensor; :func:`repro_torch.core.packing.pack_text` calls it on the
device it is given.  The kernel replaces no TPU kernel (the JAX package
packs on the host with numpy).  Launches are counted in
``pack_text_dense.launches``.  It is not an entry of ``ops.KERNELS``,
whose kernels are the construction and search kernels the benchmark's
roofline reads.
"""

from __future__ import annotations

import ctypes

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.core.packing import dense_range_error
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.packed_gather import _on_cpu, _require, _stream

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong


def pack_text_dense(codes: torch.Tensor, n_words: int, bits: int,
                    alphabet: str = "") -> torch.Tensor:
    """int32[n_words] dense words (uint32 bit patterns) of the uint8 real
    codes ``codes``, ``32 // bits`` symbols a word big-endian and zero
    past the codes.  Raises :class:`ValueError` when a code does not fit
    in ``bits`` bits (``alphabet`` names the alphabet in the message)."""
    if bits not in (2, 4, 8):
        raise ValueError(f"unsupported dense bits {bits}")
    n_real = codes.shape[0]
    if n_words < -(-n_real // (32 // bits)):
        raise ValueError(f"{n_words} words cannot hold {n_real} codes")
    _require(codes, "codes", torch.uint8, 1)
    fake = is_fake(codes)  # no values (the dry run): shapes only
    if fake or _on_cpu(codes):
        if not fake and n_real and int(codes.max()) >= 1 << bits:
            raise dense_range_error(bits, alphabet, int(codes.max()))
        return _ref.pack_text_dense_ref(codes, n_words, bits)
    words = torch.empty(n_words, dtype=torch.int32, device=codes.device)
    bad = torch.zeros(1, dtype=torch.int32, device=codes.device)
    fn = _build.entry("pack_text_dense",
                      [_P, _I64, _I64, ctypes.c_int, _P, _P, _P])
    with torch.cuda.device(codes.device):
        rc = fn(codes.data_ptr(), n_real, n_words, bits, words.data_ptr(),
                bad.data_ptr(), _stream(codes.device))
    _build.check(rc, "pack_text_dense")
    pack_text_dense.launches += 1
    if bad.item():
        raise dense_range_error(bits, alphabet, int(codes.max()))
    return words


pack_text_dense.launches = 0

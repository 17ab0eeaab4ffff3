"""Wrapper of the byte-key probe CUDA kernel (the byte-text search step).

:func:`pattern_probe` runs ``csrc/pattern_probe.cu``, the port of
``repro/kernels/pattern_probe.py:pattern_probe``, for CUDA tensors and the
plain version (:func:`repro_torch.kernels.ref.pattern_probe_ref`) for CPU
tensors.  Launches are counted in ``pattern_probe.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.packed_gather import (
    _check_probe_rows,
    _on_cpu,
    _stream,
)
from repro_torch.kernels.range_gather import require_byte_text

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong


def pattern_probe(s_padded: torch.Tensor, pos: torch.Tensor,
                  pat_words: torch.Tensor,
                  mask_words: torch.Tensor) -> torch.Tensor:
    """int32[B] in {−1, 0, +1}: the suffix at each ``pos`` of the
    terminal-padded uint8 string against its packed, masked pattern row
    (0: the suffix starts with the pattern), bit-identical to
    :func:`repro_torch.kernels.ref.pattern_probe_ref`."""
    if _on_cpu(s_padded, pos, pat_words, mask_words):
        return _ref.pattern_probe_ref(s_padded, pos, pat_words, mask_words)
    require_byte_text(s_padded)
    _check_probe_rows(pos, pat_words, mask_words)
    b, nw = pat_words.shape
    out = torch.empty(b, dtype=torch.int32, device=pos.device)
    if b == 0:
        return out
    fn = _build.entry("pattern_probe",
                      [_P, _I64, _P, _P, _P, _I64, ctypes.c_int, _P, _P])
    with torch.cuda.device(pos.device):
        rc = fn(s_padded.data_ptr(), s_padded.shape[0], pos.data_ptr(),
                pat_words.data_ptr(), mask_words.data_ptr(), b, nw,
                out.data_ptr(), _stream(pos.device))
    _build.check(rc, "pattern_probe")
    pattern_probe.launches += 1
    return out


pattern_probe.launches = 0

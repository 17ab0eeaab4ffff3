"""Alphabet handling for ERA suffix-tree construction (PyTorch port: a copy
of the JAX package's numpy-only module, so the port imports nothing of it).

Symbols are encoded as small integer codes ``0..|Σ|-1``; the end-of-string
terminal ``$`` is always the LARGEST code ``|Σ|`` so that it sorts after
every real symbol — this matches the paper's traces (Example 2 sorts
``CGGT`` before ``C$`` and emits ``B = (G, $, 3)``).  Out-of-range gathers
read padding equal to the terminal code, which behaves like a run of
terminals: any two distinct suffixes diverge at or before the earlier
``$`` (the terminal is unique), so padding never affects a comparison that
matters.
"""

from __future__ import annotations

import dataclasses

import numpy as np

TERMINAL = "$"


@dataclasses.dataclass(frozen=True)
class Alphabet:
    """A finite symbol set plus the implicit terminal ``$`` (largest code)."""

    name: str
    symbols: str  # real symbols, codes 0..len(symbols)-1

    @property
    def terminal_code(self) -> int:
        return len(self.symbols)

    @property
    def base(self) -> int:
        """Radix for integer k-mer codes (``|Σ| + 1`` including ``$``)."""
        return len(self.symbols) + 1

    @property
    def bits_per_symbol(self) -> int:
        return max(1, int(np.ceil(np.log2(self.base))))

    @property
    def dense_bits(self) -> int:
        """Dense-packing width in bits per symbol (paper §6.1, generalized).

        Covers the REAL symbols only — the terminal is virtual in the dense
        representation (it exists only at the end of the string, so packed
        gathers substitute it by position instead of storing it; see
        :mod:`repro_torch.core.packing`).  Rounded up to a power of two dividing
        32 so symbols never straddle word boundaries: 2-bit DNA, 4-bit
        reduced-protein-class alphabets, 8-bit fallback (= byte passthrough
        density) for protein/english/byte.
        """
        need = max(1, int(np.ceil(np.log2(max(2, len(self.symbols))))))
        for bits in (2, 4, 8):
            if bits >= need:
                return bits
        return 8

    def char_of(self, code: int) -> str:
        if code == self.terminal_code:
            return TERMINAL
        return self.symbols[code]

    def encode(self, text: str, *, terminate: bool = True) -> np.ndarray:
        """Encode ``text`` to uint8 codes, appending the terminal."""
        lut = np.full(256, 255, dtype=np.uint8)
        for i, ch in enumerate(self.symbols):
            lut[ord(ch)] = i
        arr = lut[np.frombuffer(text.encode("latin-1"), dtype=np.uint8)]
        if (arr == 255).any():
            bad = sorted({text[i] for i in np.nonzero(arr == 255)[0][:8]})
            raise ValueError(f"symbols {bad!r} not in alphabet {self.name!r}")
        if terminate:
            arr = np.concatenate([arr, np.array([self.terminal_code], np.uint8)])
        return arr

    def decode(self, codes: np.ndarray) -> str:
        return "".join(self.char_of(int(c)) for c in codes)

    def random_string(self, n: int, seed: int = 0) -> np.ndarray:
        """Random terminated string of ``n`` real symbols (n+1 codes)."""
        rng = np.random.default_rng(seed)
        arr = rng.integers(0, len(self.symbols), size=n, dtype=np.uint8)
        return np.concatenate([arr, np.array([self.terminal_code], np.uint8)])

    def pad_string(self, codes: np.ndarray, extra: int, pad_to_multiple: int = 1) -> np.ndarray:
        """Terminal-pad so gathers up to ``extra`` past the end are safe."""
        n = len(codes)
        target = n + extra
        if pad_to_multiple > 1:
            target = -(-target // pad_to_multiple) * pad_to_multiple
        out = np.full(target, self.terminal_code, dtype=np.uint8)
        out[:n] = codes
        return out


DNA = Alphabet("dna", "ACGT")
PROTEIN = Alphabet("protein", "ACDEFGHIKLMNPQRSTVWY")
ENGLISH = Alphabet("english", "abcdefghijklmnopqrstuvwxyz")
# Murphy-10 reduced protein classes (one representative letter per class:
# LVIM, C, A, G, ST, P, FYW, EDNQ, KR, H) — 10 symbols fit 4-bit dense
# packing, the "protein-class" tier between 2-bit DNA and the 8-bit
# fallback that full 20-letter protein needs.
PROTEIN_CLASS = Alphabet("protein_class", "LCAGSPFEKH")
# Raw bytes 0..254 (terminal = 255): indexes arbitrary binary data.  Codes
# above 127 reach the sign bit of packed int32 words, which is why every
# packed-word sort/comparison runs unsigned (see repro_torch.core.packing).
BYTE = Alphabet("byte", "".join(chr(i) for i in range(255)))

ALPHABETS = {a.name: a for a in (DNA, PROTEIN, PROTEIN_CLASS, ENGLISH, BYTE)}

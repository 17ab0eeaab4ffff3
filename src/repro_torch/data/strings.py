"""String datasets for the ERA indexing engine (numpy only).

A copy of the generators in the JAX package's ``repro.data.strings`` —
``synthetic_string`` plants repeats (deep suffix-tree paths stress the
elastic range) and ``dataset`` names the paper's dataset kinds — so both
packages index the same string from the same seed.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.alphabet import ALPHABETS, Alphabet


def synthetic_string(alphabet: Alphabet, n: int, *, seed: int = 0,
                     repeat_fraction: float = 0.3,
                     repeat_len: int = 64) -> np.ndarray:
    """Random string with planted repeats (deep suffix-tree paths)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, len(alphabet.symbols), size=n, dtype=np.uint8)
    n_rep = int(n * repeat_fraction / max(1, repeat_len))
    if n_rep and n > 2 * repeat_len:
        motif = rng.integers(0, len(alphabet.symbols), size=repeat_len, dtype=np.uint8)
        for _ in range(n_rep):
            p = int(rng.integers(0, n - repeat_len))
            base[p : p + repeat_len] = motif
    return np.concatenate([base, np.array([alphabet.terminal_code], np.uint8)])


def dataset(name: str, n: int, seed: int = 0) -> tuple[np.ndarray, Alphabet]:
    """Named datasets mirroring the paper's evaluation set."""
    if name in ("dna", "genome"):
        a = ALPHABETS["dna"]
    elif name == "protein":
        a = ALPHABETS["protein"]
    elif name == "english":
        a = ALPHABETS["english"]
    elif name == "byte":
        a = ALPHABETS["byte"]
    else:
        raise KeyError(name)
    rep = {"dna": 0.30, "genome": 0.45, "protein": 0.15, "english": 0.20,
           "byte": 0.10}[name]
    return synthetic_string(a, n, seed=seed, repeat_fraction=rep), a

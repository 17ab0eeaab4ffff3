"""String datasets for the ERA indexing engine (numpy only).

The port's copy of the JAX package's ``repro.data.strings``:
``synthetic_string`` plants repeats (deep suffix-tree paths stress the
elastic range) and ``dataset`` names the paper's dataset kinds, so both
packages index the same string from the same seed; ``load_fasta`` reads a
real genome or protein set; ``BlockStream`` is the paper's sequential
block reader for strings that exceed a memory budget.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

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


def load_fasta(path: str, alphabet: Alphabet, *,
               max_symbols: int | None = None) -> np.ndarray:
    """Concatenate FASTA records into one terminated code string.

    Header (``>``) and comment (``;``) lines and blank lines are skipped;
    sequence lines are stripped, upper-cased and every ``N`` becomes the
    alphabet's first symbol, as the JAX package reads them.  Reading stops
    at the line that reaches ``max_symbols``, which then truncates.  The
    lines are encoded together, once, so a genome-sized file costs one
    table lookup instead of one per line.
    """
    lines = []
    total = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith((">", ";")):
                continue
            line = line.upper().replace("N", alphabet.symbols[0])
            lines.append(line)
            total += len(line)
            if max_symbols and total >= max_symbols:
                break
    s = alphabet.encode("".join(lines), terminate=False)
    if max_symbols:
        s = s[:max_symbols]
    return np.concatenate([s, np.array([alphabet.terminal_code], np.uint8)])


@dataclasses.dataclass
class StreamStats:
    blocks_read: int = 0
    bytes_read: int = 0
    seeks: int = 0


class BlockStream:
    """Sequential block reader over a code string — the paper's disk model.

    ``read_all()`` streams every block in order (WaveFront discipline);
    ``read_for_offsets(offs, w)`` streams only blocks containing a needed
    symbol, skipping gaps with a seek (paper §4.4 heuristic).  The counts
    feed the I/O model.
    """

    def __init__(self, s: np.ndarray, block_bytes: int = 1 << 20):
        self.s = s
        self.block = block_bytes
        self.stats = StreamStats()

    def read_all(self) -> Iterator[np.ndarray]:
        n_blocks = -(-len(self.s) // self.block)
        for b in range(n_blocks):
            self.stats.blocks_read += 1
            self.stats.bytes_read += self.block
            yield self.s[b * self.block : (b + 1) * self.block]

    def read_for_offsets(self, offs: np.ndarray,
                         w: int) -> Iterator[tuple[int, np.ndarray]]:
        if len(offs) == 0:
            return
        lo = np.asarray(offs) // self.block
        hi = (np.asarray(offs) + w - 1) // self.block
        needed = np.unique(np.concatenate(
            [np.arange(a, b + 1) for a, b in zip(lo, hi)]))
        prev = None
        for b in needed:
            if prev is not None and b != prev + 1:
                self.stats.seeks += 1
            self.stats.blocks_read += 1
            self.stats.bytes_read += self.block
            prev = b
            yield int(b), self.s[b * self.block : (b + 1) * self.block]


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

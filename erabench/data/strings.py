"""Seeded synthetic strings with planted repeats: the yardstick's generator.

A frozen copy of the port's ``data/strings.synthetic_string`` semantics
(uniform symbols over the alphabet, ``repeat_fraction * n / repeat_len``
copies of one random motif of ``repeat_len`` symbols planted at uniform
starts, the terminal appended), written so that a 2^27-symbol string
takes a second or two: the starts are drawn in one call and sorted, and
the motif is written once over the positions each start keeps after the
later starts have overwritten theirs, which is what planting the sorted
starts one after another in a loop leaves behind (:func:`plant_loop`, the
test's form).

It lives under the benchmark's own directory so that no change to the
program moves the strings a cell is measured on.
"""

from __future__ import annotations

import numpy as np


def _rng(seed: int, index: int) -> np.random.Generator:
    """One stream per (run seed, string index); any seed up to 2**63."""
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), int(index)])


def draw(n: int, sigma: int, seed: int, index: int, repeat_fraction: float,
         repeat_len: int):
    """(base symbols, sorted motif starts, motif) of one string."""
    rng = _rng(seed, index)
    base = rng.integers(0, sigma, size=n, dtype=np.uint8)
    n_rep = int(n * repeat_fraction / max(1, repeat_len))
    if not n_rep or n <= 2 * repeat_len:
        return base, np.zeros(0, np.int64), np.zeros(0, np.uint8)
    motif = rng.integers(0, sigma, size=repeat_len, dtype=np.uint8)
    starts = np.sort(rng.integers(0, n - repeat_len, size=n_rep))
    return base, starts, motif


def plant(base: np.ndarray, starts: np.ndarray, motif: np.ndarray) -> None:
    """Plant ``motif`` at every sorted start in place, vectorised: start k
    keeps the positions from it up to the next start or its motif's end,
    which is what the loop leaves once later starts have overwritten."""
    if starts.size == 0:
        return
    n, m = base.size, motif.size
    dt = np.int64 if n >= 1 << 31 else np.int32
    st = starts.astype(dt)
    ln = np.minimum(np.diff(st, append=dt(n)), m).astype(dt)
    first = np.cumsum(ln, dtype=np.int64) - ln
    rel = np.arange(int(first[-1] + ln[-1]), dtype=dt)
    rel -= np.repeat(first.astype(dt), ln)
    base[rel + np.repeat(st, ln)] = motif[rel]


def plant_loop(base: np.ndarray, starts: np.ndarray,
               motif: np.ndarray) -> None:
    """The looped form of :func:`plant`: each sorted start in turn."""
    m = motif.size
    for p in starts:
        base[p:p + m] = motif


def synthetic_string(n: int, sigma: int, seed: int, index: int, *,
                     repeat_fraction: float, repeat_len: int) -> np.ndarray:
    """uint8 codes ``0..sigma-1`` of ``n`` symbols, then the terminal
    ``sigma`` (the largest code, as the port's alphabets have it)."""
    base, starts, motif = draw(n, sigma, seed, index, repeat_fraction,
                               repeat_len)
    plant(base, starts, motif)
    return np.concatenate([base, np.array([sigma], np.uint8)])

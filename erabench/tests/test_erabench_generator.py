"""The frozen generator against its own looped form, and pinned by hash:
a change to the program cannot move the strings a cell runs on."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest

from erabench.data import strings

# sha256 of the 2^12-symbol strings (terminal included), loop form
PINNED = {
    ("genome", 0):
        "9e8138281e3b56291f460eaed8ad4b50dea51588a52fc58907e437d402d094bb",
    ("protein", 1):
        "78929dcc7b4bedc5ac0f22970385c3e16eadaeb4b12d14d377b91f3775f3ddf2",
}
PARAMS = {"genome": (4, 0.45), "protein": (20, 0.15)}


def looped(n, sigma, seed, index, frac):
    base, starts, motif = strings.draw(n, sigma, seed, index, frac, 64)
    strings.plant_loop(base, starts, motif)
    return np.concatenate([base, np.array([sigma], np.uint8)])


@pytest.mark.parametrize("name,index", sorted(PINNED))
def test_pinned_hash(name, index):
    sigma, frac = PARAMS[name]
    s = looped(1 << 12, sigma, 2**40 + 3, index, frac)
    fast = strings.synthetic_string(1 << 12, sigma, 2**40 + 3, index,
                                    repeat_fraction=frac, repeat_len=64)
    assert np.array_equal(s, fast)
    assert hashlib.sha256(s.tobytes()).hexdigest() == PINNED[(name, index)]


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 11, 2**62 + 5])
def test_vectorised_plant_equals_loop(seed):
    for n, sigma, frac in ((1 << 12, 4, 0.45), (3000, 4, 0.95),
                           (1 << 12, 20, 0.15), (200, 20, 0.6)):
        base, starts, motif = strings.draw(n, sigma, seed, 0, frac, 64)
        a, b = base.copy(), base.copy()
        strings.plant(a, starts, motif)
        strings.plant_loop(b, starts, motif)
        assert np.array_equal(a, b)


def test_two_strings_of_a_seed_differ():
    a = strings.synthetic_string(1 << 12, 4, 5, 0, repeat_fraction=0.45,
                                 repeat_len=64)
    b = strings.synthetic_string(1 << 12, 4, 5, 1, repeat_fraction=0.45,
                                 repeat_len=64)
    assert a[-1] == b[-1] == 4 and not np.array_equal(a, b)
    assert (a[:-1] < 4).all()

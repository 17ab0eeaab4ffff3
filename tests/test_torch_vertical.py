"""PyTorch port vs the JAX package: vertical partitioning and grouping.

Equal prefixes, frequencies, occurrence positions and groups, on the
``dna``/``genome`` datasets and a 4-bit alphabet, across budgets that reach
the histogram kernel's bin limit (base**t > 2**16 falls to the
searchsorted count) and the position-refinement strategy.  The port runs
on the CPU.  Tolerance: exact.
"""

import numpy as np
import pytest

from repro.core import vertical as jv
from repro.data.strings import dataset as j_dataset
from repro.core.alphabet import PROTEIN_CLASS
from repro_torch.core import vertical as tv
from repro_torch.data.strings import dataset as t_dataset


def _compare(jp, tp):
    assert [p.symbols for p in tp] == [p.symbols for p in jp]
    assert [p.freq for p in tp] == [p.freq for p in jp]
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(b.positions.numpy(), a.positions,
                                      err_msg=str(a.symbols))


@pytest.mark.parametrize("name,n,f_max", [
    ("dna", 3000, 200), ("genome", 6000, 900), ("dna", 2000, 3),
    ("genome", 4000, 60_000),
])
def test_prefixes_equal(name, n, f_max):
    s, alpha = t_dataset(name, n, seed=1)
    sj, _ = j_dataset(name, n, seed=1)
    np.testing.assert_array_equal(s, sj)
    js, ts = jv.VerticalStats(), tv.VerticalStats()
    jp = jv.vertical_partition(sj, alpha.base, f_max, stats=js)
    tp = tv.vertical_partition(s, alpha.base, f_max, stats=ts, device="cpu")
    _compare(jp, tp)
    assert (ts.scans, ts.bytes_scanned) == (js.scans, js.bytes_scanned)
    assert sum(p.freq for p in tp) == len(s)


def test_deep_prefixes_cross_the_kernel_bin_limit():
    """f_max = 1 on a repetitive string forces t past 6, where 5**t
    exceeds the kernel's 2**16 bins and the searchsorted count runs."""
    s, alpha = t_dataset("genome", 1500, seed=3)
    jp = jv.vertical_partition(s, alpha.base, 1)
    tp = tv.vertical_partition(s, alpha.base, 1, device="cpu")
    assert max(p.length for p in tp) > 6
    _compare(jp, tp)


def test_protein_class_alphabet():
    s = PROTEIN_CLASS.random_string(2500, seed=4)
    jp = jv.vertical_partition(s, PROTEIN_CLASS.base, 150)
    tp = tv.vertical_partition(s, PROTEIN_CLASS.base, 150, device="cpu")
    _compare(jp, tp)


def test_positions_strategy_equal():
    s, alpha = t_dataset("dna", 2500, seed=5)
    js, ts = jv.VerticalStats(), tv.VerticalStats()
    jp = jv.vertical_partition(s, alpha.base, 100, strategy="positions",
                               stats=js)
    tp = tv.vertical_partition(s, alpha.base, 100, strategy="positions",
                               stats=ts, device="cpu")
    _compare(jp, tp)
    assert ts.refine_steps == js.refine_steps


@pytest.mark.parametrize("group", [True, False])
def test_groups_equal(group):
    s, alpha = t_dataset("genome", 5000, seed=6)
    jg = jv.vertical_partition_grouped(s, alpha.base, 700, group=group)
    tg = tv.vertical_partition_grouped(s, alpha.base, 700, group=group,
                                       device="cpu")
    assert len(tg) == len(jg) > 1
    for a, b in zip(jg, tg):
        assert [p.symbols for p in b.prefixes] == [p.symbols for p in a.prefixes]
        assert b.total_freq == a.total_freq


def test_rejects_bad_f_max():
    with pytest.raises(ValueError, match="f_max"):
        tv.vertical_partition(np.array([0, 4], np.uint8), 5, 0, device="cpu")

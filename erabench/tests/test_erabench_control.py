"""The comparison that decides ``correct`` fails what it must: the
control (the reference's order exact only to a capped depth, put in the
program's place) and each fault a build cell can have, planted under a
whole run at test size; the program itself passes."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from erabench import harness
from erabench.reference import suffix_order as R
from erabench.tests.tiny import tiny_root

CELLS = ["genome-index", "protein-tree", "protein-index", "genome-stream"]


def run_with(tmp_path, cell, keep=None, seconds=0.05):
    """A whole run on the CPU, the cell's ``keep`` replaced by ``keep(kept,
    s_i, build)`` when given (the fault planted where the answer is
    produced)."""
    root = tiny_root(tmp_path)
    c = harness.find_cell(cell, root)
    if keep is not None:
        orig = c.entry.keep
        seen = []
        c.entry.keep = lambda result: keep(orig(result), seen)
    run, kept = harness.measure(c, 2**35 + 9, seconds, False, device="cpu",
                                t_start=0.0, log=lambda m: None)
    harness.judge(run, kept, "cpu", log=lambda m: None)
    return run


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tmp_path, cell):
    """The control at depth 16 in the program's place, per string."""
    root = tiny_root(tmp_path)
    c = harness.find_cell(cell, root)
    run = harness.Run(c, pool=harness.make_strings(c, 2**35 + 9))
    base = len(c.config["symbols"]) + 1
    f_max = R.f_max_of(harness.era_config(c)["memory_bytes"])
    kept = [(i, c.entry.control(R.index_tables(
        torch.from_numpy(s), base, f_max, depth_cap=16, tree=c.entry.TREE)))
        for i, s in enumerate(run.pool)]
    run.builds = kept
    harness.judge(run, kept, "cpu", log=lambda m: None)
    assert not harness.correct(run)
    assert run.checks["wrong_builds"]["value"] == len(kept)


@pytest.mark.parametrize("cell", ["genome-index", "protein-tree"])
def test_program_is_correct(tmp_path, cell):
    run = run_with(tmp_path, cell)
    assert harness.correct(run), run.checks


def stale(kept, seen):
    """A build that returns the state of the one before it unchanged."""
    seen.append(kept)
    return seen[-2] if len(seen) > 1 else kept


def half(kept, seen):
    """Half of the result left out: the second half of the order zeroed."""
    if "subtrees" in kept:
        from erabench.entries import build_tree
        kept = {"flat": build_tree.flatten(kept["subtrees"])}
    out = kept["flat"] if "flat" in kept else dict(kept)
    ell = np.asarray(out["ell"]).copy()
    ell[len(ell) // 2:] = 0
    out["ell"] = ell
    return kept if "flat" in kept else out


def altered(kept, seen):
    """One answer altered where it is produced: two leaves swapped in the
    order, or one node's parent moved."""
    if "subtrees" in kept:
        from erabench.entries import build_tree
        flat = build_tree.flatten(kept["subtrees"])
        flat["parent"] = flat["parent"].copy()
        flat["parent"][1] = flat["parent"][0] + 1
        return {"flat": flat}
    kept = dict(kept)
    ell = kept["ell"].copy()
    ell[[3, 4]] = ell[[4, 3]]
    kept["ell"] = ell
    return kept


@pytest.mark.parametrize("fault", [stale, half, altered])
@pytest.mark.parametrize("cell", ["genome-index", "protein-tree"])
def test_fault_is_not_correct(tmp_path, cell, fault):
    for seconds in (0.25, 1.0, 4.0):  # a stale build needs one before it
        run = run_with(tmp_path / str(seconds), cell, keep=fault,
                       seconds=seconds)
        if len(run.builds) >= 2:
            break
    assert len(run.builds) >= 2
    assert not harness.correct(run), (fault.__name__, run.checks)

"""``EraIndexer.build``: the suffix tree itself, every sub-tree's leaves and
nodes on the host (the batched Cartesian-tree build)."""

from __future__ import annotations

import numpy as np

from erabench import compare
from erabench.entries._index import make, new_report

__all__ = ["TREE", "check", "control", "flatten", "keep", "make", "run"]

TREE = True


def run(program, s, params: dict):
    report = new_report()
    return program.build(s, report), {"report": report}


def keep(index) -> dict:
    """The sub-trees as the program left them on the host (no copy)."""
    return {"subtrees": index.subtrees}


def flatten(subtrees: dict) -> dict:
    """Every field concatenated in prefix order, and the prefix table."""
    prefixes = sorted(subtrees)
    subs = [subtrees[p] for p in prefixes]
    cat = lambda get: np.concatenate([np.asarray(get(t)) for t in subs])
    freq = np.array([len(t.ell) for t in subs], np.int64)
    plen = np.array([len(p) for p in prefixes], np.int64)
    pref = np.full((len(prefixes), int(plen.max())), -1, np.int32)
    for i, p in enumerate(prefixes):
        pref[i, :len(p)] = p
    return {"ell": cat(lambda t: t.ell), "b_off": cat(lambda t: t.b_off),
            "b_c1": cat(lambda t: t.b_c1), "b_c2": cat(lambda t: t.b_c2),
            "parent": cat(lambda t: t.nodes.parent),
            "depth": cat(lambda t: t.nodes.depth),
            "witness": cat(lambda t: t.nodes.witness),
            "n_nodes": np.array([int(t.nodes.n_nodes) for t in subs]),
            "sub_off": np.cumsum(freq) - freq, "sub_freq": freq,
            "sub_plen": plen, "sub_prefix": pref}


def check(kept: dict, ref: dict) -> dict:
    flat = kept.get("flat") or flatten(kept["subtrees"])
    return compare.tree_mismatch(flat, ref)


def control(ref: dict) -> dict:
    names = (compare.TREE_LEAVES + ("b_c1", "b_c2") + compare.TREE_NODES
             + ("n_nodes",) + compare.INDEX_TABLES)
    return {"flat": {k: compare.host(ref[k]) for k in names}}

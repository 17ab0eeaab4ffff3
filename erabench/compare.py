"""The comparison that decides ``correct``: a build's output against the
reference's tables of the same string, entry by entry, as counts of
entries that differ.  Every quantity is an integer: each count's limit is
0."""

from __future__ import annotations

import numpy as np
import torch


def mismatches(got, want: torch.Tensor) -> int:
    """Entries of ``got`` (numpy or tensor) that differ from ``want``; a
    length that differs counts every entry of the longer as wrong."""
    got = torch.as_tensor(np.asarray(got) if not isinstance(got, torch.Tensor)
                          else got).to(want.device)
    if got.shape != want.shape:
        return max(got.numel(), want.numel())
    return int((got.to(torch.int64) != want.to(torch.int64)).sum())


INDEX_TABLES = ("sub_off", "sub_freq", "sub_plen", "sub_prefix")


def index_mismatch(kept: dict, ref: dict) -> dict:
    """A flattened index: the suffix order, the sub-tree table and the
    routing table (a routing depth that differs fails every cell)."""
    dev = ref["ell"].device
    tables = sum(mismatches(kept[k], ref[k]) for k in INDEX_TABLES)
    if int(kept["k_route"]) != int(ref["k_route"]):
        tables += len(ref["win_lo"]) + len(ref["win_hi"]) + 1
    else:
        for k in ("win_lo", "win_hi"):
            tables += mismatches(kept[k], torch.from_numpy(ref[k]).to(dev))
    return {"ell_mismatch": mismatches(kept["ell"], ref["ell"]),
            "table_mismatch": tables}


TREE_LEAVES = ("ell", "b_off")
TREE_NODES = ("parent", "depth", "witness")


def tree_mismatch(flat: dict, ref: dict) -> dict:
    """A suffix tree flattened in sub-tree order: the leaves (position and
    LCP with the leaf before; the two divergence symbols where there is a
    leaf before), the prefix table, and every node slot and count."""
    inner = ref["inner"]
    leaves = sum(mismatches(flat[k], ref[k]) for k in TREE_LEAVES)
    for k in ("b_c1", "b_c2"):
        got = torch.as_tensor(flat[k]).to(inner.device)
        if got.shape != inner.shape:
            leaves += inner.numel()
        else:
            leaves += mismatches(got[inner], ref[k][inner])
    nodes = sum(mismatches(flat[k], ref[k]) for k in TREE_NODES)
    nodes += mismatches(flat["n_nodes"], ref["n_nodes"])
    tables = sum(mismatches(flat[k], ref[k]) for k in INDEX_TABLES)
    return {"leaf_mismatch": leaves, "node_mismatch": nodes,
            "table_mismatch": tables}


def host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()

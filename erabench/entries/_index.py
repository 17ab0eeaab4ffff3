"""What the index entries share: a flattened ``DeviceIndex`` kept on the
host and compared table by table."""

from __future__ import annotations

from erabench import compare

TREE = False


def keep(dev) -> dict:
    """The index's host suffix order and its tables (a few KiB beside the
    suffix order, which the program already holds on the host)."""
    out = {"ell": dev.ell_host, "k_route": int(dev.k_route)}
    for k in compare.INDEX_TABLES + ("win_lo", "win_hi"):
        out[k] = getattr(dev, k).cpu().numpy()
    return out


def check(kept: dict, ref: dict) -> dict:
    return compare.index_mismatch(kept, ref)


def control(ref: dict) -> dict:
    out = {k: compare.host(ref[k]) for k in ("ell",) + compare.INDEX_TABLES}
    out.update(k_route=ref["k_route"], win_lo=ref["win_lo"],
               win_hi=ref["win_hi"])
    return out


def new_report():
    from repro_torch.core.api import BuildReport
    from repro_torch.core.prepare import PrepareStats
    from repro_torch.core.vertical import VerticalStats
    return BuildReport(VerticalStats(), PrepareStats())


def make(alphabet, era_config: dict, params: dict, device):
    from repro_torch.core.api import EraConfig, EraIndexer
    return EraIndexer(alphabet, EraConfig(**era_config), device=device)

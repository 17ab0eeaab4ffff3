"""``EraIndexer.build_device``: the string to a flattened, device-resident
index (partition, prepare, flatten), its suffix order also on the host."""

from __future__ import annotations

from erabench.entries._index import TREE, check, control, keep, make, new_report

__all__ = ["TREE", "check", "control", "keep", "make", "run"]


def run(program, s, params: dict):
    report = new_report()
    return program.build_device(s, report), {"report": report}

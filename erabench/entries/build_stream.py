"""``EraIndexer.build_stream``: the out-of-core build, the groups in chunks
whose state fits ``device_budget`` bytes, the copy of chunk k + 1 behind
the loop of chunk k (``overlap``); the index equals ``build_device``'s."""

from __future__ import annotations

from erabench.entries._index import TREE, check, control, keep, make, new_report

__all__ = ["TREE", "check", "control", "keep", "make", "run"]


def run(program, s, params: dict):
    report = new_report()
    dev, stream = program.build_stream(
        s, report, device_budget=int(params["device_budget"]),
        overlap=bool(params["overlap"]))
    return dev, {"report": report, "stream": stream}

"""A copy of the benchmark at test size: the checkout's ``BENCHMARK.json``
and ``erabench/`` in a temporary root, every configuration cut to 2^12
symbols under a 4 KiB budget (dozens of sub-trees, prefixes up to a few
symbols deep) and the stream's state budget to a few chunks."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
N = 1 << 12


def tiny_root(tmp: Path) -> Path:
    shutil.copytree(ROOT / "erabench", tmp / "erabench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for path in (tmp / "erabench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["n"] = N
        cfg["era_config"]["memory_bytes"] = 4096
        path.write_text(json.dumps(cfg))
    for path in (tmp / "erabench" / "traffic").glob("*.json"):
        tr = json.loads(path.read_text())
        if "device_budget" in tr.get("params", {}):
            tr["params"]["device_budget"] = 20000
        path.write_text(json.dumps(tr))
    return tmp

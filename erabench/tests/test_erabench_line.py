"""The result line has exactly the contract's keys, ``checks`` last, and
the command prints no result without a card."""

from __future__ import annotations

import subprocess
import sys

import pytest

from erabench import harness
from erabench.tests.tiny import ROOT, tiny_root


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(tmp_path, trace):
    line = harness.run_cell("protein-index", 2**40 + 1, 0.05, trace,
                            device="cpu", root=tiny_root(tmp_path),
                            log=lambda m: None)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert {"vertical_s", "prepare_s", "prepare_iterations",
                "flatten_s"} <= set(line["metrics"])
    else:
        assert set(line["metrics"]) == {"build_sym_s", "setup_s"}
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"} and c["value"] == c["limit"] == 0


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, str(ROOT / "erabench" / "run.py"), "--workload",
         "genome-index", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""

"""The readers of the build's named host time and copies (``text_s``,
``flatten_span_s``, ``slice_s``, ``to_host_gib``, ``to_device_gib``)
report in a traced run of each cell that lists them, at test size on the
CPU, and report nothing for a program without the timers and counters
they read."""

from __future__ import annotations

import dataclasses

import pytest

from erabench import harness
from erabench.tests.tiny import ROOT, tiny_root

NEW = ("text_s", "flatten_span_s", "slice_s", "to_host_gib",
       "to_device_gib")
BENCH = harness.load_json(ROOT / "BENCHMARK.json")
LISTS = {m["name"]: m["workloads"] for m in BENCH["per_layer"]
         if m["name"] in NEW}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_readers_report_in_their_cells(tmp_path, cell):
    line = harness.run_cell(cell, 2**33 + 5, 0.05, True, device="cpu",
                            root=tiny_root(tmp_path), log=lambda m: None)
    assert line["correct"]
    got = {k: v["value"] for k, v in line["metrics"].items()}
    want = {name for name, cells in LISTS.items() if cell in cells}
    assert want <= set(got) and not (set(NEW) - want) & set(got)
    assert got["text_s"] > 0
    assert got["to_host_gib"] > 0 and got["to_device_gib"] > 0
    if "flatten_span_s" in want:  # the timers lie inside the remainder
        assert 0 < got["text_s"] + got["flatten_span_s"] <= got["flatten_s"]
    if "slice_s" in want:
        assert 0 < got["slice_s"] <= got["prepare_s"]


@dataclasses.dataclass
class _OldReport:
    """A ``BuildReport`` of a program without the new timers and counters."""
    t_vertical: float = 1.0
    t_prepare: float = 2.0
    t_build: float = 3.0


@pytest.mark.parametrize("name", NEW)
def test_readers_report_nothing_without_the_program_fields(name):
    entry = {"slice_s": "build_tree"}.get(name, "build_device")
    cell = harness.Cell("c", 1, {"n": 8}, {"entry": entry}, None, [], [])
    run = harness.Run(cell, window_s=1.0, builds=[
        harness.Build(0, 1.0, 0, {"report": _OldReport()})])
    mod = harness.load_module(ROOT / "erabench" / "metrics" / f"{name}.py")
    assert mod.read(run) is None

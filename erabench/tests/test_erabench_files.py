"""Every file BENCHMARK.json names is found by name and parses, the file
keeps to the benchmark contract's shape, and a cell added as files alone
is found and runs."""

from __future__ import annotations

import json
import re

import pytest

from erabench import harness
from erabench.tests.tiny import ROOT, tiny_root

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["erabench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10


def test_entries_keep_to_the_contract():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for section, want in keys.items():
        for row in BENCH[section]:
            assert set(row) - {"workloads"} == want, row
            assert NAME.match(row["name"]), row["name"]
            for k in ("why", "layer", "source"):
                if k in row:
                    assert 1 <= len(row[k]) <= 200 and "\n" not in row[k]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert len(set(CELLS)) == len(CELLS)
    assert len(set(METRICS)) == len(METRICS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    c = harness.find_cell(cell)
    assert c.n > 0 and len(c.config["symbols"]) >= 2
    for attr in ("make", "run", "keep", "check", "control", "TREE"):
        assert hasattr(c.entry, attr)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert c.per_layer


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_found_by_name(metric):
    mod = harness.load_module(ROOT / "erabench" / "metrics" / f"{metric}.py")
    assert callable(mod.read)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file_parses(config):
    row = next(c for c in BENCH["configs"] if c["name"] == config)
    cfg = json.loads((ROOT / row["file"]).read_text())
    assert row["file"] == f"erabench/configs/{config}.json"
    assert cfg["source"] == row["source"]
    assert set(row["reduced"]) == set(cfg["reduced"]) <= set(
        cfg["source_values"])
    assert cfg["symbols"] and cfg["n"] > 0


def test_a_cell_added_as_files_runs(tmp_path):
    """A new configuration, traffic, cell and per-layer metric: files and
    BENCHMARK.json entries only, no edit of a file that is there."""
    root = tiny_root(tmp_path)
    here = root / "erabench"
    cfg = json.loads((here / "configs" / "genome.json").read_text())
    cfg.update(symbols="ACGT", repeat_fraction=0.8)
    (here / "configs" / "dna-dense.json").write_text(json.dumps(cfg))
    (here / "traffic" / "index-three.json").write_text(json.dumps(
        {"entry": "build_device", "pool": 3, "params": {}}))
    (here / "workloads" / "dna-dense-index.json").write_text(json.dumps(
        {"config": "dna-dense", "traffic": "index-three"}))
    (here / "metrics" / "sub_trees.py").write_text(
        "def read(run):\n    return float(len(run.builds))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dna-dense", "source": "test",
                             "file": "erabench/configs/dna-dense.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "dna-dense-index",
                               "config": "dna-dense",
                               "traffic": "index-three", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "sub_trees", "unit": "count",
                               "better": "lower", "source": "program_counter",
                               "layer": "partition", "moves": "build_sym_s",
                               "workloads": ["dna-dense-index"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    line = harness.run_cell("dna-dense-index", 7, 0.05, True, device="cpu",
                            root=root, log=lambda m: None)
    assert line["correct"] and line["attempted"] >= 1
    assert line["metrics"]["sub_trees"]["value"] == line["attempted"]

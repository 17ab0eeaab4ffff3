"""A whole run of each cell at test size on the card (``-m cuda``)."""

from __future__ import annotations

import pytest
import torch

from erabench import harness
from erabench.tests.tiny import tiny_root


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run with -m cuda on the card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["genome-index", "protein-tree",
                                  "protein-index", "genome-stream"])
@pytest.mark.parametrize("trace", [False, True])
def test_cell_on_the_card(tmp_path, card, cell, trace):
    line = harness.run_cell(cell, 2**36 + 5, 0.2, trace, device=card,
                            root=tiny_root(tmp_path), log=lambda m: None)
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["memory_peak_bytes"] > 0
    if trace:
        assert line["device"]["busy_s"] > 0
        assert "device_idle_pct" in line["metrics"]

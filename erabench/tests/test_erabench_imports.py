"""Nothing the benchmark runs loads JAX or the JAX package, by top-level
module name compared whole (``repro_torch`` is not ``repro``), and the
reference loads nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from erabench import harness
from erabench.tests.tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    files = sorted((ROOT / "erabench").rglob("*.py"))
    assert len(files) > 10
    for path in files:
        assert not FORBIDDEN & set(imported_tops(path)), path
    for path in sorted((ROOT / "erabench" / "reference").rglob("*.py")):
        assert "repro_torch" not in set(imported_tops(path)), path


def test_whole_names_only():
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "repro")
    sys.modules.setdefault("repro_torch_lookalike", sys)
    assert "repro_torch_lookalike" not in harness.forbidden_modules()


def test_a_tiny_run_loads_no_jax(tmp_path):
    """A whole run on the CPU in a fresh process, then ``sys.modules``."""
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from erabench import harness\n"
        "from erabench.tests.tiny import tiny_root\n"
        "from pathlib import Path\n"
        f"root = tiny_root(Path({str(tmp_path)!r}))\n"
        "line = harness.run_cell('genome-index', 3, 0.05, False, "
        "device='cpu', root=root, log=lambda m: None)\n"
        "print(json.dumps([line['correct'], harness.forbidden_modules(), "
        "sorted({m.split('.')[0] for m in sys.modules})]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    ok, found, tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert ok and found == [] and "repro_torch" in tops
    assert not FORBIDDEN & set(tops)

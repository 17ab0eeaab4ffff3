"""PyTorch port vs the JAX package: the slice end to end.

``EraIndexer.build_device`` → ``DeviceIndex.find_batch`` in the port must
equal the JAX package and ``repro.core.ref.occurrences`` on the ``dna``
and ``genome`` datasets at several memory budgets, with every index array
identical.  The port runs on the CPU (``device="cpu"``); the default
device is the card, and asking for it here raises.  Tolerance: exact.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import ref
from repro.core.api import EraConfig as JConfig
from repro.core.api import EraIndexer as JIndexer
from repro.data.strings import dataset as j_dataset
from repro_torch.core.alphabet import ALPHABETS
from repro_torch.core.api import BuildReport, EraConfig, EraIndexer
from repro_torch.core.prepare import PrepareStats
from repro_torch.core.vertical import VerticalStats
from repro_torch.data.strings import dataset
from repro_torch.launch import query_serve

ROOT = Path(__file__).resolve().parents[1]
INDEX_FIELDS = ("ell", "sub_off", "sub_freq", "sub_prefix", "sub_plen",
                "win_lo", "win_hi", "pows", "spans")


def _patterns(s, rng, count=40):
    pats = []
    for _ in range(count):
        m = int(rng.integers(1, 20))
        i = int(rng.integers(0, len(s) - 1 - m))
        pats.append(np.asarray(s[i : i + m]))
    for _ in range(10):
        pats.append(rng.integers(0, 4, size=int(rng.integers(1, 10)))
                    .astype(np.uint8))
    return pats


@pytest.mark.parametrize("name,n,mem", [
    ("dna", 4000, 1 << 12), ("dna", 3000, 1 << 16),
    ("genome", 6000, 1 << 12), ("genome", 5000, 1 << 14),
])
def test_build_device_find_batch_equal(name, n, mem):
    s, alpha = dataset(name, n, seed=0)
    sj, alpha_j = j_dataset(name, n, seed=0)
    np.testing.assert_array_equal(s, sj)
    report = BuildReport(VerticalStats(), PrepareStats())
    tdev = EraIndexer(alpha, EraConfig(memory_bytes=mem, build_impl="none"),
                      device="cpu").build_device(s, report)
    jdev = JIndexer(alpha_j, JConfig(memory_bytes=mem, build_impl="none")
                    ).build_device(sj)
    for field in INDEX_FIELDS:
        np.testing.assert_array_equal(getattr(tdev, field).numpy(),
                                      np.asarray(getattr(jdev, field)),
                                      err_msg=field)
    assert (tdev.k_route, tdev.n_iter, tdev.base) == (jdev.k_route,
                                                      jdev.n_iter, jdev.base)
    assert report.n_groups >= 1 and report.capacity >= 1
    assert sorted(tdev.ell_host.tolist()) == list(range(len(s)))
    pats = _patterns(s, np.random.default_rng(n + mem))
    for p, g, w in zip(pats, tdev.find_batch(pats), jdev.find_batch(pats)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, ref.occurrences(s, p))


def test_protein_class_dense_end_to_end():
    a = ALPHABETS["protein_class"]
    s = a.random_string(2500, seed=3)
    cfg = dict(memory_bytes=4096, r_bytes=128, build_impl="none")
    tdev = EraIndexer(a, EraConfig(**cfg), device="cpu").build_device(s)
    from repro.core.alphabet import PROTEIN_CLASS
    jdev = JIndexer(PROTEIN_CLASS, JConfig(**cfg)).build_device(s)
    np.testing.assert_array_equal(tdev.ell_host, np.asarray(jdev.ell_host))
    rng = np.random.default_rng(8)
    pats = [np.asarray(s[i:i + 5]) for i in rng.integers(0, 2400, 20)]
    for g, w in zip(tdev.find_batch(pats), jdev.find_batch(pats)):
        np.testing.assert_array_equal(g, w)


def test_default_device_is_the_card():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present: the default device runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EraIndexer(ALPHABETS["dna"], EraConfig())


@pytest.mark.parametrize("kw,exc,match", [
    (dict(construction="serial"), NotImplementedError, "A14"),
    (dict(packing="bytes"), NotImplementedError, "A7"),
    (dict(construction="bogus"), ValueError, "construction"),
    (dict(packing="bogus"), ValueError, "packing"),
    (dict(build_impl="bogus"), ValueError, "build_impl"),
    (dict(node_lcp="bogus"), ValueError, "node_lcp"),
])
def test_config_rejections(kw, exc, match):
    with pytest.raises(exc, match=match):
        EraIndexer(ALPHABETS["dna"], EraConfig(**kw), device="cpu")


def test_byte_alphabets_rejected_under_auto_packing():
    with pytest.raises(NotImplementedError, match="A7"):
        EraIndexer(ALPHABETS["protein"], EraConfig(), device="cpu")


def test_config_budget_matches_jax():
    for mem in (1 << 10, 64 << 20):
        t, j = EraConfig(memory_bytes=mem), JConfig(memory_bytes=mem)
        assert (t.f_max, t.mts_bytes, t.r_symbols) == (j.f_max, j.mts_bytes,
                                                       j.r_symbols)
        assert t.elastic_config().__dict__ == j.elastic_config().__dict__
    assert EraConfig().f_max == 1_258_291


def test_serve_queries_on_cpu():
    stats = query_serve.serve_queries("dna", n=3000, batch=16, iters=3,
                                      memory_bytes=4096, device="cpu")
    assert stats["queries"] == 48 and stats["device"] == "cpu"
    assert stats["hits"] > 0 and stats["qps"] > 0
    with pytest.raises(ValueError, match="max_len"):
        query_serve.serve_queries("dna", n=10, max_len=24, device="cpu")


@pytest.mark.parametrize("name", ["dna", "genome", "protein", "english", "byte"])
def test_datasets_equal(name):
    s, a = dataset(name, 3000, seed=5)
    sj, aj = j_dataset(name, 3000, seed=5)
    np.testing.assert_array_equal(s, sj)
    assert a.symbols == aj.symbols


def test_port_imports_no_jax():
    """The port stands alone: importing every module pulls in no JAX and
    nothing of the JAX package."""
    code = ("import sys\n"
            "import repro_torch.core.api, repro_torch.core.query\n"
            "import repro_torch.launch.query_serve, repro_torch.kernels.ops\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={"PYTHONPATH": str(ROOT / "src"),
                        "PATH": "/usr/bin:/bin"})
    for path in list((ROOT / "src" / "repro_torch").rglob("*.py")) + [
            ROOT / "chip_smoke.py"]:
        text = path.read_text()
        assert "import jax" not in text and "from repro." not in text \
            and "from repro import" not in text, path

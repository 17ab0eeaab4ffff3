"""PyTorch port vs the JAX package: the ported paths end to end.

``EraIndexer.build_device`` → ``DeviceIndex.find_batch`` in the port must
equal the JAX package and ``repro.core.ref.occurrences`` on the ``dna``
and ``genome`` datasets (dense words) and on the ``protein``, ``english``
and ``byte`` datasets and DNA under ``packing="bytes"`` (byte keys), at
several memory budgets, with every index array identical.  The port runs
on the CPU (``device="cpu"``); the default device is the card, and asking
for it here raises.  Tolerance: exact.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

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


def _patterns(s, rng, count=40, n_sym=4):
    pats = []
    for _ in range(count):
        m = int(rng.integers(1, 20))
        i = int(rng.integers(0, len(s) - 1 - m))
        pats.append(np.asarray(s[i : i + m]))
    for _ in range(10):
        pats.append(rng.integers(0, n_sym, size=int(rng.integers(1, 10)))
                    .astype(np.uint8))
    return pats


def _assert_same_index(tdev, jdev, s):
    for field in INDEX_FIELDS:
        np.testing.assert_array_equal(getattr(tdev, field).numpy(),
                                      np.asarray(getattr(jdev, field)),
                                      err_msg=field)
    assert (tdev.k_route, tdev.n_iter, tdev.base) == (jdev.k_route,
                                                      jdev.n_iter, jdev.base)
    assert tdev.packed == jdev.packed and tdev.s_bits == jdev.s_bits
    assert tdev.string_nbytes == jdev.string_nbytes
    np.testing.assert_array_equal(tdev.string_codes(), s)


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


@pytest.mark.parametrize("name,n,mem,packing", [
    ("protein", 5000, 1 << 13, "auto"), ("protein", 3000, 1 << 16, "auto"),
    ("english", 4000, 1 << 13, "auto"), ("byte", 3000, 1 << 12, "auto"),
    ("dna", 4000, 1 << 12, "bytes"),
])
def test_byte_build_device_find_batch_equal(name, n, mem, packing):
    """The byte-key path: tables and ell array for array, every answer
    equal to JAX and to the brute-force occurrence scan."""
    s, alpha = dataset(name, n, seed=0)
    sj, alpha_j = j_dataset(name, n, seed=0)
    kw = dict(memory_bytes=mem, build_impl="none", packing=packing)
    tdev = EraIndexer(alpha, EraConfig(**kw), device="cpu").build_device(s)
    jdev = JIndexer(alpha_j, JConfig(**kw)).build_device(sj)
    assert not tdev.packed and tdev.s_padded.dtype == torch.uint8
    _assert_same_index(tdev, jdev, s)
    np.testing.assert_array_equal(tdev.s_padded.numpy(),
                                  np.asarray(jdev.s_padded))
    pats = _patterns(s, np.random.default_rng(n + mem),
                     n_sym=len(alpha.symbols))
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
    (dict(construction="serial"), None, None),
    (dict(construction="bogus"), ValueError, "construction"),
    (dict(packing="bogus"), ValueError, "packing"),
    (dict(build_impl="bogus"), ValueError, "build_impl"),
    (dict(node_lcp="bogus"), ValueError, "node_lcp"),
])
def test_config_rejections(kw, exc, match):
    """Unknown knobs are refused; ``construction="serial"`` is accepted
    and builds the serial engine's index, equal to JAX's."""
    if exc is None:
        s = ALPHABETS["dna"].random_string(800, seed=1)
        cfg = dict(memory_bytes=2048, r_bytes=64, **kw)
        tidx = EraIndexer(ALPHABETS["dna"], EraConfig(**cfg),
                          device="cpu").build(s)
        from repro.core.alphabet import DNA
        jidx = JIndexer(DNA, JConfig(**cfg)).build(s)
        assert list(tidx.subtrees) == list(jidx.subtrees)
        for p, st in jidx.subtrees.items():
            np.testing.assert_array_equal(tidx.subtrees[p].ell, st.ell)
        return
    with pytest.raises(exc, match=match):
        EraIndexer(ALPHABETS["dna"], EraConfig(**kw), device="cpu")


@pytest.mark.parametrize("name", ["dna", "protein_class", "protein"])
def test_config_packing_bytes_equal(name):
    """``packing="bytes"`` keeps any alphabet byte per symbol, as in JAX:
    the build and the served string are byte text, and both packages
    give the same index."""
    a = ALPHABETS[name]
    s = a.random_string(2000, seed=6)
    kw = dict(memory_bytes=4096, r_bytes=128, build_impl="none",
              packing="bytes")
    tix = EraIndexer(a, EraConfig(**kw), device="cpu")
    assert isinstance(tix._device_text(s), torch.Tensor)
    tdev = tix.build_device(s)
    from repro.core.alphabet import ALPHABETS as J_ALPHABETS
    jdev = JIndexer(J_ALPHABETS[name], JConfig(**kw)).build_device(s)
    _assert_same_index(tdev, jdev, s)
    assert not tdev.packed
    pats = _patterns(s, np.random.default_rng(2), count=20,
                     n_sym=len(a.symbols))
    for g, w in zip(tdev.find_batch(pats), jdev.find_batch(pats)):
        np.testing.assert_array_equal(g, w)


def test_byte_alphabets_rejected_under_auto_packing():
    """Once refused, now built: protein, english and byte under the default
    ``packing="auto"`` run the byte-key currency and equal JAX."""
    from repro.core.alphabet import ALPHABETS as J_ALPHABETS
    for name in ("protein", "english", "byte"):
        a = ALPHABETS[name]
        s = a.random_string(1500, seed=len(name))
        cfg = dict(memory_bytes=4096, r_bytes=128, build_impl="none")
        tix = EraIndexer(a, EraConfig(**cfg), device="cpu")
        assert tix._device_text(s).dtype == torch.uint8
        tdev = tix.build_device(s)
        jdev = JIndexer(J_ALPHABETS[name], JConfig(**cfg)).build_device(s)
        np.testing.assert_array_equal(tdev.ell_host, np.asarray(jdev.ell_host))
        pats = [np.asarray(s[i:i + 6]) for i in (0, 100, 700, 1490)]
        for g, w in zip(tdev.find_batch(pats), jdev.find_batch(pats)):
            np.testing.assert_array_equal(g, w)


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


@pytest.mark.parametrize("name", ["protein", "english", "byte"])
def test_serve_queries_byte_datasets_match_jax(name):
    """``query_serve --dataset protein|english|byte --device cpu`` gives
    the JAX package's ``query_serve`` answers for the same seed."""
    from repro.launch import query_serve as j_query_serve
    kw = dict(n=2500, batch=16, iters=3, memory_bytes=4096, seed=3)
    stats = query_serve.serve_queries(name, device="cpu", **kw)
    jstats = j_query_serve.serve_queries(name, **kw)
    for key in ("n_symbols", "n_subtrees", "k_route", "queries", "hits"):
        assert stats[key] == jstats[key], key
    assert stats["hits"] > 0


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
            "import repro_torch.core.analytics, repro_torch.core.suffix_tree\n"
            "import repro_torch.launch.analytics_serve\n"
            "import repro_torch.launch.serving, repro_torch.kernels.probe_gather\n"
            "import repro_torch.launch.serve, repro_torch.models.transformer\n"
            "import repro_torch.obs, repro_torch.obs.trace\n"
            "import repro_torch.obs.metrics, repro_torch.launch.shard_run\n"
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

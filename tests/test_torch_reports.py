"""PyTorch port vs the JAX package: the reports of the three launch modules.

``query_serve.serve_queries``, ``analytics_serve.serve_analytics`` and
``serving.serve_stream`` of the port (on the CPU) and of the JAX package,
on the same dataset, seed and sizes: every field that does not depend on
timing (hits, ``mean_match_len``, ``distinct_substrings``,
``longest_repeat``, counts, batch shapes, cache counters) is equal
exactly, and every timing field is rounded to the places JAX rounds it
to.  The port's extra keys (``device``, ``n_iter``) are its only others.

The training driver's ``main`` prints the JAX driver's lines from the
same parameters (for qwen3-1.7b and a moe, an ssm and a hybrid arch): the step exactly, the loss and the gradient norm within
one unit of their last printed place (float32 sums in another order), and
``tok/s`` in JAX's format; its parser takes JAX's command lines to the
same ``train`` arguments, and ``--mesh prod`` / ``multipod`` fail on one
rank as JAX's ``jax.make_mesh`` fails on one device.
"""

import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.launch import analytics_serve as j_analytics
from repro.launch import query_serve as j_query
from repro.launch import serving as j_serving
from repro.launch import train as j_train
from repro.models import transformer as JT
from repro.models.config import smoke_config as j_smoke
from repro.models.registry import get_config as j_get
from repro_torch.launch import analytics_serve as t_analytics
from repro_torch.launch import query_serve as t_query
from repro_torch.launch import serving as t_serving
from repro_torch.launch import train as t_train
from repro_torch.models import transformer as T

# the timing fields of the JAX reports and the places each is rounded to
TIMING = {"t_build_s": 3, "qps": 1, "batch_p50_ms": 3, "batch_p99_ms": 3,
          "positions_per_s": 1, "lat_p50_ms": 3, "lat_p99_ms": 3,
          "wall_s": 4, "vs_sync": 2}
PORT_ONLY = {"device", "n_iter"}

REPORTS = {
    "query_serve": (t_query.serve_queries, j_query.serve_queries,
                    dict(n=2500, batch=32, iters=3, memory_bytes=4096,
                         seed=3)),
    "query_serve_protein": (t_query.serve_queries, j_query.serve_queries,
                            dict(n=2000, batch=16, iters=2,
                                 memory_bytes=4096, seed=5)),
    "analytics_serve": (t_analytics.serve_analytics,
                        j_analytics.serve_analytics,
                        dict(n=3000, batch=128, iters=2, window=32, seed=2)),
    "serving": (t_serving.serve_stream, j_serving.serve_stream,
                dict(n=2000, requests=192, seed=4)),
}


def _assert_report(got: dict, want: dict, where: str) -> None:
    assert set(got) - PORT_ONLY == set(want), where
    for key, w in want.items():
        g = got[key]
        if key in TIMING:
            assert g == round(g, TIMING[key]), f"{where}.{key} = {g!r}"
        elif isinstance(w, dict):
            _assert_report(g, w, f"{where}.{key}")
        else:
            assert g == w, f"{where}.{key}: {g!r} != {w!r}"


@pytest.mark.parametrize("module", sorted(REPORTS))
def test_launch_report_equals_jax(module):
    port, jax_fn, kw = REPORTS[module]
    dataset = "protein" if module.endswith("protein") else "dna"
    got = port(dataset, device="cpu", **kw)
    want = jax_fn(dataset, **kw)
    _assert_report(got, want, module)
    assert got["device"] == "cpu"


# ---- the training driver --------------------------------------------------

TRAIN_LINE = re.compile(
    r"step +(\d+)  loss (\d+\.\d{4})  gnorm (\d+\.\d{3})  "
    r"tok/s (\d{1,3}(?:,\d{3})*)")


def _step_lines(out: str) -> list[tuple]:
    rows = []
    for line in out.splitlines():
        m = TRAIN_LINE.fullmatch(line)
        assert m, f"not a driver line: {line!r}"
        rows.append((int(m[1]), float(m[2]), float(m[3])))
    return rows


def test_train_main_lines_equal_jax(monkeypatch, capsys):
    _assert_main_lines(monkeypatch, capsys, [], rtol=0.0)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "falcon-mamba-7b",
                                  "zamba2-2.7b"])
def test_train_main_lines_equal_jax_families(arch, monkeypatch, capsys):
    """The driver's lines for an arch of each family it trains beside the
    dense one (moe, ssm, hybrid; MLA's losses are held in
    ``tests/test_torch_train.py``), as for qwen3-1.7b, each figure also
    allowed the later steps' rtol of ``tests/test_torch_train.py``
    (5e-4): phi3.5-moe's gradient norm reaches ~111 by step 10, where its
    last printed place is 1e-5 of it (measured 1.8e-5 apart)."""
    _assert_main_lines(monkeypatch, capsys, ["--arch", arch], rtol=5e-4)


def _assert_main_lines(monkeypatch, capsys, extra: list, rtol: float) -> None:
    def init(seed, cfg, dtype, device):  # the JAX driver's parameters
        jp = JT.init_params(jax.random.PRNGKey(0), j_smoke(j_get(cfg.name)),
                            jnp.float32)
        return T.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device)
    monkeypatch.setattr(t_train.T, "init_params", init)
    argv = extra + ["--steps", "11", "--batch", "2", "--seq", "16"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    j_train.main()
    want = _step_lines(capsys.readouterr().out)
    t_train.main(argv + ["--device", "cpu"])
    got = _step_lines(capsys.readouterr().out)
    assert [r[0] for r in got] == [r[0] for r in want] == [1, 10]
    for (_, loss, gnorm), (_, jloss, jgnorm) in zip(got, want):
        assert abs(loss - jloss) <= max(1e-4, rtol * abs(jloss)) + 1e-9
        assert abs(gnorm - jgnorm) <= max(1e-3, rtol * abs(jgnorm)) + 1e-9


JAX_COMMAND_LINES = [
    [],
    ["--full"],
    ["--arch", "gemma3-4b", "--smoke", "--steps", "5", "--batch", "4",
     "--seq", "64", "--lr", "1e-3", "--ckpt-dir", "ck", "--mesh", "host"],
    ["--mesh", "prod"],
    ["--mesh", "multipod", "--full", "--steps", "7"],
    ["--arch", "falcon-mamba-7b", "--steps", "3", "--seq", "32"],
    ["--arch", "deepseek-v2-236b", "--full", "--batch", "1"],
    ["--arch", "zamba2-2.7b", "--mesh", "prod"],
]


@pytest.mark.parametrize("argv", JAX_COMMAND_LINES, ids=lambda a: " ".join(a) or "defaults")
def test_train_parser_takes_jax_command_lines(argv, monkeypatch):
    seen = {}
    monkeypatch.setattr(j_train, "train",
                        lambda arch, **kw: seen.setdefault("jax", dict(arch=arch, **kw)))
    monkeypatch.setattr(j_train, "make_host_mesh", lambda: "host")
    monkeypatch.setattr(j_train, "make_production_mesh",
                        lambda multi_pod=False: "multipod" if multi_pod else "prod")
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    j_train.main()
    want = dict(seen["jax"])
    parsed = vars(t_train.build_parser().parse_args(argv))
    assert parsed.pop("device") == "cuda"
    assert parsed == {"arch": want["arch"], "smoke": want["smoke"],
                      "steps": want["steps"], "batch": want["batch"],
                      "seq": want["seq"], "lr": want["lr"],
                      "ckpt_dir": want["ckpt_dir"], "mesh": want["mesh"]}
    if want["mesh"] != "host":  # the real mesh, before it reads a device:
        # one rank is too few, as one device is for the JAX driver
        shape = "(2, 16, 16)" if want["mesh"] == "multipod" else "(16, 16)"
        with pytest.raises(ValueError, match=re.escape(
                f"Number of devices 1 must be >= the product of mesh_shape "
                f"{shape}")):
            t_train.main(argv)
        return
    monkeypatch.setattr(t_train, "train",
                        lambda arch, **kw: seen.setdefault("port", dict(arch=arch, **kw)))
    t_train.main(argv)
    got = seen["port"]
    assert got.pop("device") == "cuda"
    assert got == want

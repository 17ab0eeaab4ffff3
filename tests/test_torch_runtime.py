"""PyTorch port vs the JAX package: the work queue, the worker driver and
the ERA-str oracle.

``WorkQueue`` must pull, complete, fail and requeue as JAX's does on one
sequence (the clock patched in both), and a checkpoint either package
writes must resume in the other; ``build_distributed`` must give JAX's
sub-trees and timing-free queue stats, also with a worker failed
mid-run; ``era_run.main`` must print JAX's timing-free lines in the
worker and ``--stream`` modes; ``branch_edge`` must give JAX's trees and
``StrStats``.  The port runs on the CPU.  Tolerance: exact.
"""

import ast
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from repro.core import branch_edge as jbe
from repro.core.alphabet import ALPHABETS as J_ALPHABETS
from repro.core.api import EraConfig as JConfig
from repro.launch import era_run as jera
from repro.runtime.scheduler import WorkQueue as JQueue
from repro_torch.core import branch_edge as tbe
from repro_torch.core.alphabet import ALPHABETS
from repro_torch.core.api import EraConfig, EraIndexer
from repro_torch.core.build import nodes_to_intervals
from repro_torch.launch import era_run as tera
from repro_torch.runtime.scheduler import WorkQueue as TQueue

ROOT = Path(__file__).resolve().parents[1]
COSTS = [5.0, 9.0, 1.0, 9.0, 3.0, 7.0]


class _Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def _drive(queue_cls, clock, ckpt=None):
    """One sequence of pulls, completions, a node failure and a missed
    deadline; the observable trace of the queue."""
    q = queue_cls(deadline_factor=2.0, min_deadline_s=1.0,
                  checkpoint_path=ckpt)
    q.add_tasks(COSTS, payloads=[f"g{i}" for i in range(len(COSTS))])
    trace = []

    def pull(w):
        t = q.pull(w)
        trace.append((w, None if t is None else (t.task_id, t.payload,
                                                 t.attempts)))
        return t

    a, b, c = pull("w0"), pull("w1"), pull("w2")
    clock.now += 2.0
    q.complete(a.task_id, worker="w0", elapsed_s=2.0)
    trace.append(("lost", q.mark_failed("w1")))
    d = pull("w0")
    clock.now += 100.0  # c and d miss their deadlines
    e = pull("w3")
    q.complete(c.task_id, worker="w2", elapsed_s=1.0)
    q.complete(c.task_id, worker="w2", elapsed_s=1.0)  # duplicate: ignored
    while (t := pull("w3")) is not None:
        q.complete(t.task_id, worker="w3", elapsed_s=0.5)
    for t in (b, d, e):
        q.complete(t.task_id, worker="late", elapsed_s=0.5)
    trace.append(("stats", q.stats(), q.drained, q.remaining))
    return trace, q


def test_work_queue_matches_jax(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    jtrace, jq = _drive(JQueue, clock)
    clock.now = 100.0
    ttrace, tq = _drive(TQueue, clock)
    assert ttrace == jtrace
    assert jtrace[-1][1]["reattempts"] > 0 and jtrace[-1][2]
    assert tq._completed_log == jq._completed_log


@pytest.mark.parametrize("writer,reader", [(JQueue, TQueue), (TQueue, JQueue)])
def test_checkpoints_resume_across_packages(tmp_path, monkeypatch, writer,
                                            reader):
    """A JSONL checkpoint one package writes: the other skips its
    recorded groups, and the files are byte-identical."""
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    paths = {}
    for cls in (JQueue, TQueue):
        paths[cls] = str(tmp_path / f"{cls.__module__}.jsonl")
        q = cls(checkpoint_path=paths[cls])
        q.add_tasks(COSTS)
        for w in ("w0", "w1"):
            t = q.pull(w)
            q.complete(t.task_id, worker=w, elapsed_s=1.5,
                       result_meta={"subtrees": 3})
    with open(paths[JQueue]) as f, open(paths[TQueue]) as g:
        assert f.read() == g.read()
    q = reader(checkpoint_path=paths[writer])
    q.add_tasks(COSTS)
    assert q.remaining == len(COSTS) - 2 and q.stats()["done"] == 2
    assert q.pull("w9").task_id == 5  # the largest cost left (7.0)


def _timing_free(stats):
    return {k: v for k, v in stats.items() if k != "ema_cost_rate"}


@pytest.mark.parametrize("fail", [None, "w1"])
def test_build_distributed_matches_jax(fail):
    s = ALPHABETS["dna"].random_string(3000, seed=4)
    kw = dict(memory_bytes=2048, r_bytes=256, build_impl="none")
    jidx, jstats, jworkers = jera.build_distributed(
        s, J_ALPHABETS["dna"], JConfig(**kw), n_workers=3, fail_worker=fail,
        fail_after=1, groups_per_pull=2)
    tidx, tstats, tworkers = tera.build_distributed(
        s, ALPHABETS["dna"], EraConfig(**kw), n_workers=3, fail_worker=fail,
        fail_after=1, groups_per_pull=2, device="cpu")
    assert _timing_free(tstats) == _timing_free(jstats)
    assert tstats["done"] == tstats["total"]
    assert (tstats["reattempts"] > 0) == (fail is not None)
    assert [(w.worker, w.groups) for w in tworkers] == [
        (w.worker, w.groups) for w in jworkers]
    assert list(tidx.subtrees) == list(jidx.subtrees)
    for p, st in jidx.subtrees.items():
        for f in ("ell", "b_off", "b_c1", "b_c2"):
            np.testing.assert_array_equal(getattr(tidx.subtrees[p], f),
                                          getattr(st, f))
    # exact despite the failure: the serial engine's sub-trees
    serial = EraIndexer(ALPHABETS["dna"],
                        EraConfig(construction="serial", **kw),
                        device="cpu").build(s)
    for p, st in serial.subtrees.items():
        np.testing.assert_array_equal(tidx.subtrees[p].ell, st.ell)


DIST_KW = dict(memory_bytes=2048, r_bytes=256, build_impl="none")


def _dist(s, **kw):
    return tera.build_distributed(s, ALPHABETS["dna"], EraConfig(**DIST_KW),
                                  n_workers=3, groups_per_pull=2,
                                  device="cpu", **kw)


@pytest.mark.parametrize("writer", ["port", "port_partial", "jax"])
def test_build_distributed_resumes_into_a_whole_index(tmp_path, writer):
    """A run resumed from a checkpoint (the port's, its first records
    only, or the JAX driver's): the workers skip the recorded groups, and
    the index still holds every sub-tree, equal to a fresh build's.  (The
    checkpoint records no sub-trees: JAX's driver returns the index
    without them.)"""
    s = ALPHABETS["dna"].random_string(3000, seed=4)
    want, _, _ = _dist(s)
    ckpt = tmp_path / "groups.jsonl"
    if writer == "jax":
        jera.build_distributed(s, J_ALPHABETS["dna"], JConfig(**DIST_KW),
                               n_workers=3, groups_per_pull=2,
                               checkpoint_path=str(ckpt))
    else:
        _dist(s, checkpoint_path=str(ckpt))
    records = ckpt.read_text().splitlines()
    if writer == "port_partial":
        records = records[:len(records) // 2]
        ckpt.write_text("".join(r + "\n" for r in records))
    got, stats, workers = _dist(s, checkpoint_path=str(ckpt))
    assert stats["done"] == stats["total"] >= len(records) > 0
    assert sum(w.groups for w in workers) == stats["total"] - len(records)
    assert sorted(got.subtrees) == sorted(want.subtrees)
    for p, st in want.subtrees.items():
        for f in ("ell", "b_off", "b_c1", "b_c2"):
            np.testing.assert_array_equal(getattr(got.subtrees[p], f),
                                          getattr(st, f))


@pytest.mark.parametrize("n_workers,fail", [(1, "w0"), (0, None)])
def test_build_distributed_raises_without_a_worker(n_workers, fail):
    """Every worker failed (or none given): an error, not an endless
    requeue."""
    s = ALPHABETS["dna"].random_string(3000, seed=4)
    with pytest.raises(RuntimeError if n_workers else ValueError,
                       match="every worker failed" if n_workers
                       else "needs a worker"):
        tera.build_distributed(s, ALPHABETS["dna"], EraConfig(**DIST_KW),
                               n_workers=n_workers, fail_worker=fail,
                               fail_after=1, groups_per_pull=2, device="cpu")


def _lines(text):
    """The printed lines with every timing taken out: floats before "s"
    or "ms", the queue's EMA rate and the overlap fraction."""
    out = []
    for line in text.strip().splitlines():
        if line.startswith("queue: "):
            line = "queue: " + repr(_timing_free(ast.literal_eval(line[7:])))
        line = re.sub(r"\d+\.\d+(m?s)\b", r"_\1", line)
        line = re.sub(r"overlap_frac=\d+\.\d+", "overlap_frac=_", line)
        out.append(line)
    return out


@pytest.mark.parametrize("mode", [[], ["--stream", "--device-budget-mb",
                                       "0.02"]])
def test_era_run_main_matches_jax(monkeypatch, capsys, mode):
    argv = ["--n", "3000", "--memory-mb", "0.002", "--workers", "3",
            "--batch-groups", "2", *mode]
    monkeypatch.setattr(sys, "argv", ["era_run", *argv])
    jera.main()
    want = _lines(capsys.readouterr().out)
    tera.main(["--device", "cpu", *argv])
    got = _lines(capsys.readouterr().out)
    assert got == want
    assert got[-1].startswith("leaves=3001 ")
    if mode:
        assert "chunks, overlap=on" in got[0] and "copied=" in got[1]


def test_era_run_accepts_the_autotune_flags_without_effect(monkeypatch,
                                                          capsys, tmp_path):
    """JAX's ``--autotune`` / ``--autotune-table`` run, print what the
    command prints without them, and set no environment."""
    for var in ("REPRO_AUTOTUNE", "REPRO_AUTOTUNE_TABLE"):
        monkeypatch.delenv(var, raising=False)
    argv = ["--device", "cpu", "--n", "2000", "--memory-mb", "0.002",
            "--workers", "2"]
    tera.main(argv)
    want = _lines(capsys.readouterr().out)
    tera.main([*argv, "--autotune", "model", "--autotune-table",
               str(tmp_path / "t.json")])
    assert _lines(capsys.readouterr().out) == want
    assert "REPRO_AUTOTUNE" not in os.environ
    assert "REPRO_AUTOTUNE_TABLE" not in os.environ


def test_smoke_bounds_read_the_hopper_limits():
    """``chip_smoke.bound`` divides by ``HopperLimits``, and gives the
    digits the data-sheet constants it had inline gave."""
    import importlib.util
    from repro_torch.roofline.hopper import HopperLimits
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.LIMITS = HopperLimits()
    for nbytes, ops in ((4 * 134217729 + 16 * 134217729, 0.0),
                        (2.0e6, 3.1e12), (1.0, 0.0)):
        inline = (nbytes / 3.35e12 * 1e3, ops / 67e12 * 1e3)
        want = ((inline[0], "bytes") if inline[0] >= inline[1]
                else (inline[1], "operations"))
        assert smoke.bound(nbytes, ops) == want
    assert HopperLimits().bf16_flops == 989e12


class _Session:
    """A profiler session that recorded ``n`` launches of one kernel."""

    def __init__(self, n):
        self.n = n

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def key_averages(self):
        ev = lambda key, count, us: type("E", (), dict(
            key=key, count=count, self_device_time_total=us))
        return [ev("range_gather_words_rows<2, 1>", self.n, 10.0 * self.n),
                ev("elementwise_kernel", 7, 99.0)]


@pytest.mark.parametrize("recorded,want", [
    ([4], 0.01), ([3, 0, 4], 0.01), ([3, 2, 5], None)])
def test_bench_device_ms_counts_the_launches(monkeypatch, recorded, want):
    """``gather_bench._device_ms`` (4 calls, one launch each) reads a
    session only when it recorded every launch, runs a short one again,
    and gives None (not measured) after three short ones."""
    import torch
    from repro_torch.launch import gather_bench
    sessions = iter(recorded)
    monkeypatch.setattr(torch.profiler, "profile",
                        lambda **kw: _Session(next(sessions)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    got = gather_bench._device_ms(lambda: None, reps=4,
                                  key="range_gather_words")
    assert got == want


def test_bench_in_turns_drops_unmeasured_sessions(monkeypatch):
    """Device turns: the median of the sessions that recorded every
    launch; None for a call none of whose sessions did."""
    from repro_torch.launch import gather_bench
    reads = {"a": iter([2.0, None]), "b": iter([None, None])}
    monkeypatch.setattr(gather_bench, "_device_ms",
                        lambda fn, key: next(reads[fn()]))
    got = gather_bench.in_turns({"a": lambda: "a", "b": lambda: "b"},
                                device=True)
    assert got == {"a": 2.0, "b": None}


@pytest.mark.parametrize("name", ["dna", "protein"])
def test_branch_edge_matches_jax(name):
    """ERA-str and the WaveFront model: the same intervals and StrStats as
    JAX's, and the intervals of the elastic-range sub-trees."""
    s = ALPHABETS[name].random_string(800, seed=9)
    idx = EraIndexer(ALPHABETS[name], EraConfig(memory_bytes=2048,
                                                r_bytes=64),
                     device="cpu").build(s)
    for p in list(idx.subtrees)[:6]:
        st = idx.subtrees[p]
        pos = np.sort(st.ell)
        for fn in ("compute_suffix_subtree", "wavefront_build"):
            js, ts = jbe.StrStats(), tbe.StrStats()
            jroot = getattr(jbe, fn)(s, pos, len(p), js)
            troot = getattr(tbe, fn)(s, pos, len(p), ts)
            want = jbe.tree_to_intervals(jroot, s)
            assert tbe.tree_to_intervals(troot, s) == want
            assert (ts.scans, ts.levels, ts.nodes) == (js.scans, js.levels,
                                                       js.nodes)
            if len(st.ell) > 1:
                assert want == nodes_to_intervals(st.nodes), p


def test_new_modules_import_no_jax():
    """The slice's modules and examples stand alone: importing them pulls
    in no JAX and nothing of the JAX package."""
    code = ("import importlib.util, sys\n"
            "import repro_torch.launch.era_run, repro_torch.runtime.scheduler\n"
            "import repro_torch.core.branch_edge, repro_torch.roofline.hopper\n"
            "import repro_torch.launch.block_sweep\n"
            "for name in ('torch_genome_indexing', 'torch_distributed_build',\n"
            "             'torch_quickstart'):\n"
            "    spec = importlib.util.spec_from_file_location(\n"
            "        name, f'examples/{name}.py')\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env={"PYTHONPATH": str(ROOT / "src"),
                        "PATH": os.environ.get("PATH", "/usr/bin:/bin")})

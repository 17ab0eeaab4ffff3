"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: fake
tensors over a fake process group, held against the JAX package's dry run
where both can say the same thing.

* The five custom ops on the dry run's path pass ``torch.library.opcheck``
  on CPU inputs; each fake output has the plain output's shape, dtype and
  strides; a call on fake tensors launches nothing and runs no plain
  version.
* ``model_flops``, ``_tokens_per_step``, ``_depth_points``, ``_with_depth``
  and the skipped cells with their reasons equal JAX's for every arch and
  shape (``repro.launch.dryrun`` is imported with ``XLA_FLAGS`` restored).
* Cells at ``smoke_config`` widths on 8-rank fake worlds, (2, 4) and
  (2, 2, 2), each traced once a worker and shared between tests: a train,
  prefill, decode (and long-decode) cell of every family ends ``ok``,
  the hybrid's also where its 2 SSM heads split 4 ways; on a (1, 1)
  world the per-device FLOPs equal ``FlopCounterMode``'s count of the
  same step on real CPU tensors, with no collective; on a data-only
  (8, 1) world a train cell's FLOPs are 1/8 of that count and its
  gradient all-reduce is recorded; the linear fit of
  ``extrapolated_costs`` equals the full-depth trace; five cells (the
  hybrid's (2, 4) train and decode among them) are held against JAX's
  compiled program (one subprocess with 8 host devices, layers unrolled,
  run beside the traces): argument bytes equal, less the 4 bytes of
  JAX's traced cache position, which the port keeps on the host; FLOPs,
  peak and wire bytes within loose bounds.
* ``ssm._mamba2_heads`` through the dry run's split plan on 4-rank gloo
  worlds (1-D and (2, 2) meshes; heads that divide the mesh dimension,
  2 and 3 heads split 4 ways; full sequences, prefill states, decode from
  a cache split on its head channels or on its heads) equals the unsplit
  call, outputs, states and gradients (``rtol`` 1e-5, ``atol`` 1e-6:
  float32 partial sums reduced across devices in another order).
* Both ERA cells on the real 16x16 fake mesh at the paper's size: ``ok``,
  no collective, the packed cell tracing ``range_gather_words`` once and
  the byte cell ``range_gather_pack`` and ``lcp_pairs`` (under
  ``REPRO_WORD_COMPARE=byte`` the packed cell ``range_gather_packed`` and
  ``lcp_pairs``), and no plain version.
* The command line writes one record per cell and resumes by key.
* After every test no process group is left, and a one-rank gloo group
  starts afterwards.

Counts and bytes compare exactly; the depth fit to 1e-12 relative.
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core.alphabet import DNA
from repro_torch.core.packing import pack_text
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.launch import steps
from repro_torch.models import transformer as T
from repro_torch.models.config import SHAPES, ShapeConfig, smoke_config
from repro_torch.models.registry import (
    ARCHS,
    cell_is_runnable,
    concrete_inputs,
    get_config,
)
from repro_torch.optim import adamw
from repro_torch.roofline import analysis as an

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _jax_dryrun():
    """``repro.launch.dryrun``, whose import sets ``XLA_FLAGS`` to 512 host
    devices: put the variable back so no JAX process started later by
    this worker inherits it."""
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jd
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return jd


@pytest.fixture(autouse=True)
def no_world_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# The custom ops
# ---------------------------------------------------------------------------

def _op_cases():
    rng = np.random.default_rng(0)
    codes = np.append(rng.integers(0, 4, 4000), 4).astype(np.uint8)
    pt = pack_text(codes, DNA, extra=64, device="cpu")
    sp = torch.from_numpy(np.concatenate([codes, np.full(64, 4, np.uint8)]))
    offs = torch.from_numpy(rng.integers(0, 4000, 300).astype(np.int32))
    mask = torch.from_numpy(rng.random(300) < 0.5)
    rows = lambda: torch.from_numpy(
        rng.integers(-2**31, 2**31, (300, 16)).astype(np.int32))
    q = torch.randn(2, 24, 4, 16, generator=torch.Generator().manual_seed(0))
    kv = torch.randn(2, 24, 2, 16, generator=torch.Generator().manual_seed(1))
    P = torch.ops.repro_torch
    return [
        ("range_gather_words", P.range_gather_words,
         (pt.words, offs, 64, pt.bits, pt.n_real, pt.terminal, mask)),
        ("range_gather_words", P.range_gather_words,
         (pt.words, offs, 13, pt.bits, pt.n_real, pt.terminal, None)),
        ("range_gather_packed", P.range_gather_packed,
         (pt.words, offs, 16, pt.bits, pt.n_real, pt.terminal, mask)),
        ("range_gather_pack", P.range_gather_pack, (sp, offs, 16, mask)),
        ("range_gather_pack", P.range_gather_pack, (sp, offs, 4, None)),
        ("lcp_pairs", P.lcp_pairs, (rows(), rows(), 64)),
        ("flash_attention", P.flash_attention, (q, kv, kv, True)),
        ("flash_attention", P.flash_attention, (q, kv, kv, False)),
    ]


@pytest.mark.parametrize("case", range(8))
def test_custom_op_opcheck_and_fake(case):
    name, op, args = _op_cases()[case]
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result
    plain = op(*args)
    launches = ops.KERNELS[name].launches
    with FakeTensorMode(allow_non_fake_inputs=True) as fm:
        fake_args = [fm.from_tensor(a) if isinstance(a, torch.Tensor) else a
                     for a in args]
        fake = op(*fake_args)
    assert (fake.shape, fake.dtype, fake.stride()) == \
        (plain.shape, plain.dtype, plain.stride())
    assert ops.KERNELS[name].launches == launches


def test_fake_calls_launch_nothing(monkeypatch):
    """Through the wrappers, fake tensors reach neither a kernel nor a
    plain version, and no counter moves."""
    for name in ("range_gather_words_ref", "range_gather_pack_ref",
                 "range_gather_packed_ref", "lcp_pairs_ref",
                 "flash_attention_ref"):
        monkeypatch.setattr(kref, name, lambda *a, **k: pytest.fail(name))
    ops.reset_launch_counts()
    before = ops.launch_counts()
    rng = np.random.default_rng(1)
    codes = np.append(rng.integers(0, 4, 1000), 4).astype(np.uint8)
    with FakeTensorMode(allow_non_fake_inputs=True) as fm:
        pt = pack_text(codes, DNA, extra=64, device="cpu")
        pt = type(pt)(fm.from_tensor(pt.words), pt.n_real, pt.bits,
                      pt.terminal)
        offs = torch.zeros(50, dtype=torch.int32)
        mask = torch.ones(50, dtype=torch.bool)
        s = torch.zeros(1100, dtype=torch.uint8)
        assert ops.gather_words(pt, offs, 64, mask).shape == (50, 4)
        assert ops.range_gather(pt, offs, 64, mask).shape == (50, 16)
        keys = ops.range_gather(s, offs, 64, mask)
        lcp, c1, c2 = ops.lcp_pairs(keys, keys, 64)
        assert lcp.shape == c1.shape == c2.shape == (50,)
        q = torch.zeros(1, 8, 4, 16)
        assert ops.flash_attention(q, q[:, :, :2], q[:, :, :2]).shape == \
            q.shape
    assert ops.launch_counts() == before
    assert ops.range_gather_words.rows == ops.range_gather_pack.rows == 0


# ---------------------------------------------------------------------------
# The functions JAX's dry run has too
# ---------------------------------------------------------------------------

def test_cell_arithmetic_equals_jax():
    import dataclasses

    jd = _jax_dryrun()
    from repro.models.registry import get_config as jax_config

    for arch in ARCHS:
        cfg, jcfg = get_config(arch), jax_config(arch)
        assert D._depth_points(cfg) == jd._depth_points(jcfg)
        for depth in D._depth_points(cfg):
            assert dataclasses.asdict(D._with_depth(cfg, depth)) == \
                dataclasses.asdict(jd._with_depth(jcfg, depth))
        for sname, shape in SHAPES.items():
            assert D._tokens_per_step(cfg, shape) == \
                jd._tokens_per_step(jcfg, shape)
            assert D.model_flops(cfg, shape) == jd.model_flops(jcfg, shape)
            if not cell_is_runnable(cfg, shape)[0]:  # no mesh is made
                for mp in (False, True):
                    assert D.run_cell(arch, sname, mp) == \
                        jd.run_cell(arch, sname, mp)


# ---------------------------------------------------------------------------
# Cells on small fake worlds
# ---------------------------------------------------------------------------

TRAIN = ShapeConfig("train_4k", "train", 32, 8)
PREFILL = ShapeConfig("prefill_32k", "prefill", 32, 8)
DECODE = ShapeConfig("decode_32k", "decode", 32, 8)
LONG = ShapeConfig("long_500k", "decode", 64, 1)
FAMILIES = {"dense": "qwen3-1.7b", "vlm": "internvl2-2b",
            "moe": "phi3.5-moe-42b-a6.6b", "mla": "deepseek-v2-236b",
            "ssm": "falcon-mamba-7b", "hybrid": "zamba2-2.7b",
            "encdec": "seamless-m4t-medium"}
MESH_2X4 = ((2, 4), ("data", "model"))
MESH_2X2X2 = ((2, 2, 2), ("pod", "data", "model"))


MESHES = {"2x4": MESH_2X4, "2x2x2": MESH_2X2X2, "1x1": ((1, 1), ("data", "model")),
          "8x1": ((8, 1), ("data", "model"))}
SHAPES_OF = {s.kind if s is not LONG else "long": s
             for s in (TRAIN, PREFILL, DECODE, LONG)}


def _trace(cfg, shape, mesh_shape=(2, 4), axes=("data", "model"), **kw):
    with M.fake_world(int(np.prod(mesh_shape))):
        mesh = M._make_mesh(mesh_shape, axes, "cpu")
        fn, args, in_sh, _, _ = D.build_cell(cfg, shape, mesh, **kw)
        return D.trace_cell(fn, args, in_sh, mesh, CPU)


@functools.lru_cache(maxsize=None)
def _traced(arch: str, kind: str, mesh: str):
    """(DeviceCounts, memory) of the smoke-width cell, traced once a
    worker: the family cells and the cells held against JAX share it."""
    counts, mem, _ = _trace(smoke_config(get_config(arch)), SHAPES_OF[kind],
                            *MESHES[mesh])
    return counts, mem


# (kind, mesh) of each family's cells: the hybrid's train and decode on
# (2, 4) too, where its 2 SSM heads split 4 ways (its cells held against
# JAX's below)
def _cells():
    out = []
    for fam in FAMILIES:
        mesh_24 = "2x2x2" if fam == "hybrid" else "2x4"
        kinds = [("train", mesh_24), ("prefill", "2x2x2"),
                 ("decode", "2x2x2")]
        if fam in ("ssm", "hybrid"):
            kinds.append(("long", mesh_24))
        if fam == "hybrid":
            kinds += [("train", "2x4"), ("decode", "2x4")]
        for kind, mesh in kinds:
            out.append(pytest.param(fam, kind, mesh,
                                    id=f"{fam}-{SHAPES_OF[kind].name}-{mesh}"))
    return out


@pytest.mark.parametrize("fam,kind,mesh", _cells())
def test_family_cell_ok(fam, kind, mesh):
    counts, mem = _traced(FAMILIES[fam], kind, mesh)
    assert counts.flops > 0 and counts.hbm_bytes > 0
    assert mem["argument_bytes"] > 0
    assert mem["peak_estimate_bytes"] >= mem["argument_bytes"]
    flash = counts.ops.get("repro_torch.flash_attention", 0)
    if kind == "prefill" and fam not in ("ssm", "mla"):
        assert flash > 0
    if kind != "prefill":
        assert flash == 0  # decode reads the whole cache through _sdpa


@functools.lru_cache(maxsize=None)
def _real_flops(kind: str) -> int:
    cfg = smoke_config(get_config("qwen3-1.7b"))
    shape = SHAPES_OF[kind]
    params = T.init_params(0, cfg, torch.bfloat16, "cpu")
    batch = concrete_inputs(cfg, shape, dtype=torch.bfloat16, device="cpu")
    with FlopCounterMode(display=False) as fc:
        if shape.kind == "train":
            steps.make_train_step(cfg, adamw.AdamWConfig(), donate=True)(
                params, adamw.init(params), batch)
        else:
            cache = T.init_cache(cfg, shape.global_batch, shape.seq_len,
                                 torch.bfloat16, "cpu")
            if shape.kind == "prefill":
                steps.make_prefill_step(cfg)(params, batch, cache)
            else:
                cache["pos"] = shape.seq_len - 1
                steps.make_decode_step(cfg)(params, batch["tokens"], cache)
    return fc.get_total_flops()


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_one_device_flops_equal_flop_counter(kind):
    counts, _ = _traced("qwen3-1.7b", kind, "1x1")
    assert counts.flops == _real_flops(kind)
    assert counts.collectives == []


def test_data_parallel_train_divides_flops_and_all_reduces():
    counts, _ = _traced("qwen3-1.7b", "train", "8x1")
    assert counts.flops * 8 == _real_flops("train")
    coll = an.collective_stats(counts.collectives)
    assert coll.count_by_kind.get("all-reduce", 0) > 0
    # every group spans the 8 data ranks of one node
    assert {(g, n) for _, _, g, n in counts.collectives} == {(8, True)}


def test_depth_fit_equals_full_depth():
    cfg = smoke_config(get_config("qwen3-1.7b"))  # 3 layers; fit at 2, 4
    counts, _ = _traced("qwen3-1.7b", "prefill", "2x2x2")
    full = (counts.flops, counts.hbm_bytes,
            an.collective_stats(counts.collectives).wire_bytes)
    with M.fake_world(8):
        mesh = M._make_mesh(*MESH_2X2X2, "cpu")
        fit = D.extrapolated_costs(cfg, PREFILL, mesh, "none")
    assert fit == pytest.approx(full, rel=1e-12)
    assert full[2] > 0  # collectives are part of the fit


# The cells held against JAX's compiled program: family cells, so their
# traces are shared.  JAX compiles each with its layers unrolled, so its
# figures are full-depth too.
JAX_CELLS = (("qwen3-1.7b", "train", "2x4"), ("qwen3-1.7b", "prefill", "2x2x2"),
             ("falcon-mamba-7b", "decode", "2x2x2"),
             ("zamba2-2.7b", "train", "2x4"), ("zamba2-2.7b", "decode", "2x4"))

_JAX_CELLS = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, numpy as np
from jax.sharding import Mesh
from repro.launch import dryrun as jd
from repro.models import transformer as T
from repro.models.config import ShapeConfig, smoke_config
from repro.models.registry import get_config
from repro.roofline.analysis import parse_collectives
devs = np.array(jax.devices()[:8])
meshes = {"2x4": Mesh(devs.reshape(2, 4), ("data", "model")),
          "2x2x2": Mesh(devs.reshape(2, 2, 2), ("pod", "data", "model"))}
names = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}
out = {}
for arch, kind, m in CELLS:
    cfg = smoke_config(get_config(arch))
    fn, args, in_sh, out_sh, donate = jd.build_cell(
        cfg, ShapeConfig(names[kind], kind, 32, 8), meshes[m])
    with meshes[m], T.unrolled_layers():
        c = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
                    donate_argnums=donate).lower(*args).compile()
    cost = c.cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    mem = c.memory_analysis()
    coll = parse_collectives(c.as_text())
    out["|".join((arch, kind, m))] = {
        "argument_bytes": mem.argument_size_in_bytes,
        "peak_estimate_bytes": (mem.argument_size_in_bytes
                                + mem.output_size_in_bytes
                                + mem.temp_size_in_bytes
                                - mem.alias_size_in_bytes),
        "flops": float(cost.get("flops", 0.0)),
        "collectives": coll.count_by_kind,
        "wire_bytes": float(coll.wire_bytes)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def jax_compile(tmp_path_factory):
    """JAX's compile of ``JAX_CELLS`` in one subprocess with 8 host devices
    (its ``XLA_FLAGS`` stay in the subprocess), started with the module's
    first test so that it runs beside the port's traces."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    code = f"CELLS = {JAX_CELLS!r}\n" + _JAX_CELLS
    log = tmp_path_factory.mktemp("jax_cells") / "stderr.txt"
    with open(log, "w") as err:
        proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                                env=env, stdout=subprocess.PIPE, stderr=err,
                                text=True)
    yield proc, log
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_cells(jax_compile):
    """JAX's per-device figures of ``JAX_CELLS``."""
    proc, log = jax_compile
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log.read_text()[-4000:]
    return json.loads(out.strip().splitlines()[-1])


def test_argument_bytes_equal_jax(jax_cells):
    for cell in JAX_CELLS:
        _, mem = _traced(*cell)
        pos = 0 if cell[1] == "train" else 4  # JAX's int32 cache position
        assert mem["argument_bytes"] == \
            jax_cells["|".join(cell)]["argument_bytes"] - pos, cell


@pytest.mark.parametrize("cell", JAX_CELLS, ids="|".join)
def test_per_device_figures_near_jax(jax_cells, cell):
    """The per-device FLOPs, peak and wire bytes of DTensor's plan against
    XLA's, held loosely (PERF.md states the ratios): ``FlopCounterMode``
    counts products and attention only, XLA every elementwise op too, so
    the port counts at most JAX's FLOPs, and at least 3/4 of them where
    products dominate (the dense cells); peaks and wire bytes within 4x
    either way; the same all-reduces in the prefill."""
    counts, mem = _traced(*cell)
    want = jax_cells["|".join(cell)]
    coll = an.collective_stats(counts.collectives)
    assert counts.flops <= want["flops"]
    if cell[0] == "qwen3-1.7b":
        assert counts.flops >= 0.75 * want["flops"]
    assert 0.25 <= mem["peak_estimate_bytes"] / want["peak_estimate_bytes"] <= 4
    assert 0.25 <= coll.wire_bytes / want["wire_bytes"] <= 4
    if cell[1] == "prefill":
        assert coll.count_by_kind == want["collectives"]


# ---------------------------------------------------------------------------
# mamba2's split plan on real data: 4 gloo ranks
# ---------------------------------------------------------------------------

# name: (mesh shape, heads, head width, seq, xs placements, h0 placements or
# None for a full sequence, return_state); "r" rows, "c" channels, "h"
# heads, "d" head channels, "-" replicated
HEAD_PLANS = {
    "2-heads-4-ways": ((4,), 2, 8, 5, "c", None, False),
    "3-heads-4-ways": ((4,), 3, 4, 5, "c", None, False),
    "rows-and-heads": ((2, 2), 2, 8, 5, "rc", None, False),
    "prefill-whole-heads": ((2, 2), 2, 8, 5, "rc", None, True),
    "prefill-2-heads-4-ways": ((4,), 2, 8, 5, "c", None, True),
    "decode-head-channels": ((2, 2), 2, 8, 1, "rc", "rd", False),
    "decode-4-ways": ((4,), 2, 8, 1, "c", "d", False),
    "long-heads": ((2, 2), 2, 8, 1, "-c", "hd", False),
}
_HEAD_TOL = dict(rtol=1e-5, atol=1e-6)


def _head_plan_rank(rank, world, rdzv, out):
    """One gloo rank: every ``HEAD_PLANS`` case through
    ``dryrun._traced_model``'s plan, which must hand the model's step
    local shards once, its outputs, state and (full sequences) gradients
    gathered and compared with the unsplit call; rank 0 writes each
    case's largest error over its tolerance."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import ssm

    dist.init_process_group("gloo", init_method=rdzv, rank=rank,
                            world_size=world)
    codes = {"r": Shard(0), "c": Shard(2), "h": Shard(1), "d": Shard(2),
             "-": Replicate()}
    report, heads = {}, ssm._mamba2_heads
    try:
        for name, (shape, nh, hd, s, xp, hp, rs) in HEAD_PLANS.items():
            mesh = init_device_mesh("cpu", shape)
            rng = np.random.default_rng(len(report))
            f = lambda *sh: torch.from_numpy(
                rng.normal(size=sh).astype(np.float32))
            b, n = 4, 3
            full = [f(b, s, nh * hd),
                    torch.nn.functional.softplus(f(b, s, nh)),
                    -torch.exp(0.3 * f(nh)), f(b, s, n), f(b, s, n)]
            h0 = None if hp is None else f(b, nh, hd, n)
            rows = [Shard(0) if c == "r" else Replicate() for c in xp]
            pls = ([codes[c] for c in xp], rows, [Replicate()] * len(xp),
                   rows, rows)
            args = [distribute_tensor(t, mesh, pl).requires_grad_(hp is None)
                    for t, pl in zip(full, pls)]
            h0d = (None if hp is None else
                   distribute_tensor(h0, mesh, [codes[c] for c in hp]))
            ref_in = [t.clone().requires_grad_(hp is None) for t in full]
            want = heads(*ref_in, h0, hd, rs)
            seen = []  # what the plan hands the model's step: local shards
            ssm._mamba2_heads = lambda *a: seen.append(type(a[0])) or heads(*a)
            try:
                with D._traced_model():
                    got = ssm._mamba2_heads(*args, h0d, hd, rs)
            finally:
                ssm._mamba2_heads = heads
            assert seen == [torch.Tensor], (name, seen)
            errs = []
            for g, w in zip(got, want):
                assert (g is None) == (w is None), name
                if w is not None:
                    errs.append(_over_tol(g.full_tensor(), w))
            if hp is None:
                weight = f(b, s, nh * hd)
                (got[0].full_tensor() * weight).sum().backward()
                (want[0] * weight).sum().backward()
                errs += [_over_tol(a.grad.full_tensor(), r.grad)
                         for a, r in zip(args, ref_in)]
            report[name] = max(errs)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out, "w") as fh:
            json.dump(report, fh)


def _over_tol(got, want) -> float:
    """The largest |got - want| over ``atol + rtol * |want|``."""
    bound = _HEAD_TOL["atol"] + _HEAD_TOL["rtol"] * want.detach().abs()
    return float(((got.detach() - want.detach()).abs() / bound).max())


@pytest.fixture(scope="module")
def head_plans(tmp_path_factory):
    d = tmp_path_factory.mktemp("head_plans")
    out = d / "report.json"
    torch.multiprocessing.start_processes(
        _head_plan_rank, args=(4, f"file://{d}/rdzv", str(out)), nprocs=4,
        start_method="spawn")
    return json.loads(out.read_text())


@pytest.mark.parametrize("case", HEAD_PLANS)
def test_mamba2_heads_split_plan_equals_unsplit(head_plans, case):
    assert head_plans[case] <= 1.0


# ---------------------------------------------------------------------------
# The ERA cells and the command line
# ---------------------------------------------------------------------------

@pytest.fixture
def no_plain_gathers(monkeypatch):
    for name in ("range_gather_words_ref", "range_gather_pack_ref",
                 "range_gather_packed_ref", "lcp_pairs_ref"):
        monkeypatch.setattr(kref, name, lambda *a, **k: pytest.fail(name))


@pytest.mark.parametrize("packed,compare,kernels", [
    (True, "word", {"range_gather_words": 1}),
    (False, "word", {"range_gather_pack": 1, "lcp_pairs": 1}),
    (True, "byte", {"range_gather_packed": 1, "lcp_pairs": 1}),
])
def test_era_cell(monkeypatch, no_plain_gathers, packed, compare, kernels):
    monkeypatch.setenv("REPRO_WORD_COMPARE", compare)
    ops.reset_launch_counts()
    rec = D.run_era_cell(False, packed=packed, device="cpu")
    assert rec["status"] == "ok", rec.get("error")
    assert rec["collectives"]["counts"] == {}
    assert rec["collectives"]["wire_bytes_per_device"] == 0.0
    assert rec["kernels"] == kernels
    assert sum(ops.launch_counts().values()) == 0
    text = D.ERA_GENOME_N // 16 * 4 if packed else D.ERA_GENOME_N
    state = 6 * D.ERA_F_M * 4  # one (1, F) int32 state a device
    assert rec["memory"]["argument_bytes"] == text + state
    assert rec["roofline"]["chips"] == 256


def test_command_line_writes_and_resumes(tmp_path, capsys):
    out = tmp_path / "d.json"
    argv = ["--arch", "era-packed", "--multi-pod", "both", "--out", str(out),
            "--device", "cpu"]
    D.main(argv)
    recs = json.loads(out.read_text())
    assert [(r["arch"], r["mesh"], r["status"]) for r in recs] == [
        ("era-genome-packed", "16x16", "ok"),
        ("era-genome-packed", "2x16x16", "ok")]
    assert recs[0]["memory"] == recs[1]["memory"]
    D.main(["--arch", "qwen3-14b", "--shape", "long_500k", "--multi-pod",
            "off", "--out", str(out)])
    capsys.readouterr()
    D.main(argv)
    assert capsys.readouterr().out.count("[cached]") == 2
    recs = json.loads(out.read_text())
    assert len(recs) == 3 and recs[2]["status"] == "skipped"


def test_gloo_starts_after_the_fake_worlds(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1)
    try:
        assert dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()

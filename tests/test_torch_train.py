"""PyTorch port vs the JAX package: LM training (dense and vlm families;
the driver on every family).

The same parameters (the JAX package's ``init_params``, carried across by
``transformer.params_from_numpy``) and the same inputs (numpy seeds) go
through both packages on the CPU, in float32 unless stated, at the smoke
widths of ``qwen3-1.7b`` (qk_norm, GQA), ``gemma3-4b`` (sliding window
with global layers), ``qwen1.5-32b`` (qkv_bias, MHA) and ``internvl2-2b``
(the vlm frontend): ``forward_train`` under each remat setting, the loss
and every gradient leaf, ``adamw``, three train steps, ``compress``,
checkpoints written by either package and restored by the other, the
token pipeline, the ERA dedup filter and the ``train`` driver (also on
the other families' archs: their training itself is held in
``tests/test_torch_family_train.py``).

Tolerances (float32 sums taken in another order through 2–3 layers):

* logits: ``rtol`` 1e-4, ``atol`` 1e-4 of the largest logit (measured
  1.7e-5 of it, on gemma3-4b);
* the loss: ``rtol`` 1e-6; each gradient leaf: ``atol`` 2e-3 of the
  leaf's largest entry (measured 3.0e-4 on gemma3-4b, where a float64 run
  of the port puts JAX's float32 gradient 4.4e-4 and the port's 1.4e-4
  from it);
* ``adamw.update`` on identical gradients: ``rtol`` 1e-6, ``atol`` 1e-7
  (float32) or one bf16 step (``rtol`` 2^-7) for bf16 parameters; the
  moments ``rtol`` 1e-6;
* three train steps and ``train()`` losses: the first step's loss
  ``rtol`` 1e-6, the gradient norm ``rtol`` 2e-3 (the gradients'
  tolerance; measured 1.6e-4 on gemma3-4b), later losses ``rtol`` 5e-4
  (Adam's first steps move each parameter by about ``lr * sign(g)``, so a
  gradient within float noise of 0 may flip its step, measured 4.6e-5 on
  internvl2-2b); the parameters after three steps ``atol`` ``2 * lr`` a
  step;
* ``compress``, ``psum_compressed`` over two gloo ranks, checkpoints
  (bfloat16 leaves bit for bit), ``batch_at_step``, ``dedup_mask`` and a
  bfloat16 ``train()`` resumed against its straight run: exact.
"""

import inspect
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.data import tokens as j_tokens
from repro.launch import steps as j_steps
from repro.launch import train as j_train
from repro.models import transformer as JT
from repro.models.config import smoke_config as j_smoke
from repro.models.registry import get_config as j_get
from repro.optim import adamw as j_adamw
from repro.optim import compress as j_compress
from repro.runtime import checkpoint as j_ckpt
from repro_torch import pytree
from repro_torch.data import tokens as t_tokens
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train as t_train
from repro_torch.models import transformer as T
from repro_torch.models.config import smoke_config
from repro_torch.models.registry import get_config
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim import compress as t_compress
from repro_torch.runtime import checkpoint as t_ckpt

ARCH_CASES = ["qwen3-1.7b", "gemma3-4b", "qwen1.5-32b", "internvl2-2b"]
UNPORTED = ["falcon-mamba-7b", "zamba2-2.7b", "seamless-m4t-medium",
            "phi3.5-moe-42b-a6.6b", "deepseek-v2-236b"]
B, S = 2, 16
LATER_RTOL = 5e-4


def jpath(path) -> str:
    """A JAX key path as ``repro.runtime.checkpoint`` joins it."""
    return "/".join(j_ckpt._path_str(p) for p in path)


def assert_tree_close(got, want, *, rtol=0.0, atol=0.0, atol_rel=0.0):
    """Every leaf of the port's tree ``got`` against the JAX tree ``want``:
    the same paths in the same order, the same shapes, values within
    ``rtol`` and ``atol`` plus ``atol_rel`` of the leaf's largest entry."""
    jl = jax.tree_util.tree_flatten_with_path(want)[0]
    tl = list(pytree.leaves_with_paths(got))
    assert ["/".join(p) for p, _ in tl] == [jpath(p) for p, _ in jl]
    for (path, g), (_, w) in zip(tl, jl):
        w = np.asarray(w, dtype=np.float64)
        g = g.to(torch.float64).numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(
            g, w, rtol=rtol, atol=atol + atol_rel * float(np.abs(w).max()),
            err_msg="/".join(path))


class Pair:
    """One smoke model in both packages, on the same parameters."""

    def __init__(self, arch: str, seed: int = 1):
        self.arch = arch
        self.jcfg = j_smoke(j_get(arch))
        self.cfg = smoke_config(get_config(arch))
        self.jp = JT.init_params(jax.random.PRNGKey(seed), self.jcfg,
                                 jnp.float32)
        self.tp = T.params_from_numpy(jax.tree.map(np.asarray, self.jp),
                                      self.cfg, "cpu")

    def batch(self, seed: int = 3) -> dict:
        rng = np.random.default_rng(seed)
        s_total = S + self.cfg.frontend_len if self.cfg.frontend else S
        b = {"tokens": rng.integers(0, self.cfg.vocab, size=(B, S),
                                    dtype=np.int32),
             "labels": rng.integers(0, self.cfg.vocab, size=(B, s_total),
                                    dtype=np.int32)}
        if self.cfg.frontend:
            b["frontend"] = rng.normal(size=(B, self.cfg.frontend_len,
                                             self.cfg.frontend_dim)
                                       ).astype(np.float32)
        return b


def both(batch: dict):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.fixture(scope="module", params=ARCH_CASES)
def pair(request):
    return Pair(request.param)


@pytest.fixture
def no_flash(monkeypatch):
    """Training never reaches the flash_attention kernel (it has no
    backward): any call fails the test."""
    from repro_torch.models import nn as tnn

    def refuse(*a, **k):
        raise AssertionError("a training call reached flash_attention")
    monkeypatch.setattr(tnn.ops, "flash_attention", refuse)


# ---- forward_train, the loss and its gradients ------------------------------

@pytest.mark.parametrize("remat,policy", [(False, "none"), (True, "none"),
                                          (True, "dots")])
def test_forward_train_logits(pair, no_flash, remat, policy):
    jb, tb = both(pair.batch())
    want, jaux = jax.jit(lambda p, b: JT.forward_train(
        p, b, pair.jcfg, remat=remat, remat_policy=policy))(pair.jp, jb)
    got, aux = T.forward_train(pair.tp, tb, pair.cfg, remat=remat,
                               remat_policy=policy)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))
    assert aux.dtype == torch.float32 and aux.shape == () and float(aux) == 0
    assert float(jaux) == 0


@pytest.mark.parametrize("policy", ["none", "dots"])
def test_loss_and_gradients(pair, no_flash, policy):
    jb, tb = both(pair.batch(seed=4))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        j_steps.make_loss_fn(pair.jcfg, remat_policy=policy)))(pair.jp, jb)
    loss, grads = t_steps.value_and_grad(
        t_steps.make_loss_fn(pair.cfg, remat_policy=policy))(pair.tp, tb)
    assert loss.dtype == torch.float32 and not loss.requires_grad
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert_tree_close(grads, jgrads, atol_rel=2e-3)
    # a function of its inputs: the caller's tensors gain no gradient
    assert all(p.grad is None and not p.requires_grad
               for p in pytree.leaves(pair.tp))


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(7)
    logits = (rng.normal(size=(3, 5, 11)) * 20).astype(np.float32)
    labels = rng.integers(0, 11, size=(3, 5), dtype=np.int32)
    got = t_steps.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels))
    want = j_steps.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---- AdamW ----------------------------------------------------------------

def _numpy_tree(rng, scale: float) -> dict:
    return {"a": (rng.normal(size=(4, 6)) * scale).astype(np.float32),
            "b": {"c": (rng.normal(size=(5,)) * scale).astype(np.float32),
                  "d": (rng.normal(size=(2, 3, 2)) * scale).astype(np.float32)}}


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
@pytest.mark.parametrize("clip", ["active", "inactive"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(schedule, clip, dtype):
    rng = np.random.default_rng(11)
    params = _numpy_tree(rng, 1.0)
    gscale = 3.0 if clip == "active" else 0.01
    grads = [_numpy_tree(rng, gscale) for _ in range(4)]
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=6, schedule=schedule)
    jcfg, tcfg = j_adamw.AdamWConfig(**cfg), t_adamw.AdamWConfig(**cfg)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), params)
    tp = pytree.tree_map(lambda a: torch.from_numpy(a).to(tdt), params)
    js, ts = j_adamw.init(jp), t_adamw.init(tp)
    tol = (dict(rtol=1e-6, atol=1e-7) if dtype == "float32"
           else dict(rtol=2.0 ** -7))
    for i, g in enumerate(grads):
        jp, js, jm = j_adamw.update(jcfg, jax.tree.map(jnp.asarray, g), js, jp)
        tg = pytree.tree_map(torch.from_numpy, g)
        if i % 2:  # the in-place form gives the same values
            tp, ts, tm = t_adamw.update(tcfg, tg, ts, tp, donate=True)
        else:
            tp, ts, tm = t_adamw.update(tcfg, tg, ts, tp)
        assert all(p.dtype == tdt for p in pytree.leaves(tp))
        assert all(m.dtype == torch.float32 for m in pytree.leaves(ts.m))
        assert ts.step.dtype == torch.int32 and int(ts.step) == int(js.step)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-7)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert (float(tm["grad_norm"]) > 1.0) == (clip == "active")
        assert_tree_close(tp, jax.tree.map(
            lambda a: np.asarray(a.astype(jnp.float32)), jp), **tol)
        assert_tree_close(ts.m, js.m, rtol=1e-6, atol=1e-9)
        assert_tree_close(ts.v, js.v, rtol=1e-6, atol=1e-12)


def test_adamw_donated_chunks_equal(monkeypatch):
    """A donated leaf is updated in pieces of at most ``UPDATE_CHUNK``
    elements (here 7: runs of rows, a row split in pieces, a 1-D leaf in
    slices), also on a transposed (non-contiguous) gradient: the same
    parameters and moments, bit for bit, as the whole-leaf update."""
    rng = np.random.default_rng(13)
    params = _numpy_tree(rng, 1.0)
    grads = _numpy_tree(rng, 3.0)
    cfg = t_adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6)
    tg = pytree.tree_map(torch.from_numpy, grads)
    tg["a"] = torch.from_numpy(np.ascontiguousarray(grads["a"].T)).t()
    assert not tg["a"].is_contiguous()
    want = t_adamw.update(cfg, tg, t_adamw.init(pytree.tree_map(
        torch.from_numpy, params)), pytree.tree_map(torch.from_numpy, params))
    monkeypatch.setattr(t_adamw, "UPDATE_CHUNK", 7)
    tp = pytree.tree_map(lambda a: torch.from_numpy(a.copy()), params)
    ts = t_adamw.init(tp)
    got = t_adamw.update(cfg, tg, ts, tp, donate=True)
    assert all(a is b for a, b in zip(pytree.leaves(got[0]), pytree.leaves(tp)))
    for g, w in zip(pytree.leaves(got[:2]), pytree.leaves(want[:2])):
        assert torch.equal(g, w)


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_schedule_norm_and_clip_match_jax(schedule):
    cfg = dict(lr=1.0, warmup_steps=10, total_steps=100, schedule=schedule)
    for step in (0, 1, 9, 10, 11, 55, 99, 100, 250):
        got = t_adamw.schedule_lr(t_adamw.AdamWConfig(**cfg),
                                  torch.tensor(step, dtype=torch.int32))
        want = j_adamw.schedule_lr(j_adamw.AdamWConfig(**cfg), jnp.asarray(step))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-7)
    g = _numpy_tree(np.random.default_rng(2), 5.0)
    tg = pytree.tree_map(torch.from_numpy, g)
    np.testing.assert_allclose(float(t_adamw.global_norm(tg)),
                               float(j_adamw.global_norm(g)), rtol=1e-6)
    clipped, norm = t_adamw.clip_by_global_norm(tg, 1.0)
    jclipped, jnorm = j_adamw.clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    assert_tree_close(clipped, jclipped, rtol=1e-6)
    assert float(t_adamw.global_norm(clipped)) <= 1.0 + 1e-5


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-4b"])
def test_three_train_steps_match_jax(arch, no_flash):
    pair = Pair(arch, seed=2)
    cfg = dict(lr=1e-3, warmup_steps=2, total_steps=5)
    jstep = jax.jit(j_steps.make_train_step(pair.jcfg, j_adamw.AdamWConfig(**cfg)))
    tstep = t_steps.make_train_step(pair.cfg, t_adamw.AdamWConfig(**cfg))
    jp, js = pair.jp, j_adamw.init(pair.jp)
    tp, ts = pair.tp, t_adamw.init(pair.tp)
    for i in range(3):
        jb, tb = both(pair.batch(seed=10 + i))
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tm = tstep(tp, ts, tb)
        assert set(tm) == set(jm) == {"loss", "grad_norm", "lr"}
        rtol = 1e-6 if i == 0 else LATER_RTOL
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=rtol)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=2e-3)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-7)
    assert_tree_close(tp, jp, atol=3 * 2 * cfg["lr"])


# ---- gradient compression ---------------------------------------------------

def test_quantize_rounds_half_to_even_exactly():
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, 0.49], np.float32)
    for arr in (x, np.zeros(5, np.float32),
                np.random.default_rng(3).normal(size=(7, 9)).astype(np.float32)):
        q, s = t_compress.quantize_int8(torch.from_numpy(arr))
        jq, js = j_compress.quantize_int8(jnp.asarray(arr))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        np.testing.assert_array_equal(
            t_compress.dequantize_int8(q, s).numpy(),
            np.asarray(j_compress.dequantize_int8(jq, js)))


def _compress_inputs():
    rng = np.random.default_rng(9)
    return [_numpy_tree(rng, 0.1 * (i + 1)) for i in range(3)]


def test_compress_with_feedback_exact():
    grads = _compress_inputs()
    jerr = j_compress.init_error_state(grads[0])
    terr = t_compress.init_error_state(pytree.tree_map(torch.from_numpy, grads[0]))
    assert_tree_close(terr, jerr)
    for g in grads:  # the error carried across steps
        (jq, js), jerr = j_compress.compress_with_feedback(g, jerr)
        (tq, ts), terr = t_compress.compress_with_feedback(
            pytree.tree_map(torch.from_numpy, g), terr)
        assert_tree_close(tq, jq)
        assert_tree_close(ts, js)
        assert_tree_close(terr, jerr)
        assert_tree_close(t_compress.decompress(tq, ts),
                          j_compress.decompress(jq, js))


def test_psum_compressed_one_rank_group(tmp_path):
    """The port's mean over a one-rank gloo group, and with no group at
    all, equals JAX's ``pmean`` over an axis of one (``vmap`` with an axis
    name), error feedback included."""
    g = _compress_inputs()[0]
    jerr = j_compress.init_error_state(g)
    jsum, jnew = jax.vmap(lambda a, e: j_compress.psum_compressed(a, e, "dp"),
                          axis_name="dp")(
        jax.tree.map(lambda a: a[None], g), jax.tree.map(lambda a: a[None], jerr))
    jsum, jnew = (jax.tree.map(lambda a: np.asarray(a)[0], t)
                  for t in (jsum, jnew))
    tg = pytree.tree_map(torch.from_numpy, g)
    got = t_compress.psum_compressed(tg, t_compress.init_error_state(tg))
    assert_tree_close(got[0], jsum)
    assert_tree_close(got[1], jnew)
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            world_size=1, rank=0)
    try:
        got = t_compress.psum_compressed(tg, t_compress.init_error_state(tg))
    finally:
        dist.destroy_process_group()
    assert_tree_close(got[0], jsum)
    assert_tree_close(got[1], jnew)


def _rank_grads(rank: int) -> list:
    """Rank ``rank``'s gradients for two steps."""
    rng = np.random.default_rng(100 + rank)
    return [_numpy_tree(rng, 0.1 * (step + 1)) for step in range(2)]


_PSUM_RANK = r"""
import sys

import torch
import torch.distributed as dist

from repro_torch import pytree
from repro_torch.optim import compress
from repro_torch.runtime import checkpoint

rank, rdzv, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=rdzv, rank=rank, world_size=2)
try:
    steps = []
    for g in _rank_grads(rank):
        g = pytree.tree_map(torch.from_numpy, g)
        err = steps[-1][1] if steps else compress.init_error_state(g)
        steps.append(compress.psum_compressed(g, err))
finally:
    dist.destroy_process_group()
checkpoint.save(out.format(rank), steps)
"""


def test_psum_compressed_two_rank_group(tmp_path):
    """Two gloo ranks, two steps: the mean of the ranks' dequantized
    gradients and each rank's new error state equal JAX's
    ``psum_compressed`` per rank under ``vmap`` over an axis of two (the
    ``pmean`` of ``compress_with_feedback``), exactly.  Each rank is a
    process of its own that imports the port alone (a rank started by
    ``torch.multiprocessing`` would import this module, and JAX with it,
    for ~7 s)."""
    out = str(tmp_path / "rank{}.npz")
    code = ("import numpy as np\n" + inspect.getsource(_numpy_tree)
            + inspect.getsource(_rank_grads) + _PSUM_RANK)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    ranks = [subprocess.Popen([sys.executable, "-c", code, str(r),
                               f"file://{tmp_path}/rdzv", out], env=env,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in ranks:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-4000:]
    grads = [_rank_grads(r) for r in range(2)]
    pmean = jax.vmap(lambda a, e: j_compress.psum_compressed(a, e, "dp"),
                     axis_name="dp")
    jerr = jax.tree.map(lambda a: np.zeros((2,) + a.shape, np.float32),
                        grads[0][0])
    want = [[], []]
    for step in range(2):
        g = jax.tree.map(lambda *a: np.stack(a), grads[0][step],
                         grads[1][step])
        jmean, jerr = pmean(g, jerr)
        for r in range(2):
            want[r].append(jax.tree.map(lambda a: np.asarray(a)[r],
                                        (jmean, jerr)))
    for r in range(2):
        target = jax.tree.map(lambda a: torch.zeros(a.shape), want[r])
        got, _ = t_ckpt.restore(out.format(r), target)
        assert_tree_close(got, want[r])


# ---- checkpoints --------------------------------------------------------------

@pytest.fixture(scope="module")
def train_state():
    """(params, AdamWState) of the qwen3 smoke model after one step, in
    both packages (JAX's as numpy and the port's from it)."""
    pair = Pair("qwen3-1.7b", seed=5)
    step = jax.jit(j_steps.make_train_step(pair.jcfg, j_adamw.AdamWConfig(lr=1e-3)))
    jb, _ = both(pair.batch())
    jp, js, _ = step(pair.jp, j_adamw.init(pair.jp), jb)
    jstate = jax.tree.map(np.array, (jp, js))  # writable copies
    tstate = (pytree.tree_map(torch.from_numpy, jstate[0]),
              t_adamw.AdamWState(torch.from_numpy(jstate[1].step),
                                 pytree.tree_map(torch.from_numpy, jstate[1].m),
                                 pytree.tree_map(torch.from_numpy, jstate[1].v)))
    return jstate, tstate


def test_checkpoint_keys_and_both_ways(train_state, tmp_path):
    jstate, tstate = train_state
    tpath, jpath_ = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    t_ckpt.save(tpath, tstate, step=7, meta={"arch": "qwen3-1.7b"})
    j_ckpt.save(jpath_, jstate, step=7, meta={"arch": "qwen3-1.7b"})
    with np.load(tpath) as a, np.load(jpath_) as b:
        assert list(a.keys()) == list(b.keys())
        assert {"0/embed", "0/layers/attn/wq", "1/step", "1/m/embed",
                "1/v/final_norm", "__meta__"} <= set(a.keys())
        for k in a.keys():
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    # JAX restores the port's file, the port JAX's
    got_j, meta_j = j_ckpt.restore(tpath, jstate)
    got_t, meta_t = t_ckpt.restore(jpath_, tstate)
    assert meta_j == meta_t == {"step": 7, "arch": "qwen3-1.7b"}
    assert isinstance(got_t[1], t_adamw.AdamWState)
    assert got_t[1].step.dtype == torch.int32 and got_t[1].step.shape == ()
    assert all(t.device.type == "cpu" for t in pytree.leaves(got_t))
    assert_tree_close(got_t, jstate)
    assert_tree_close(tstate, got_j)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_checkpoint_errors_and_latest(tmp_path):
    p = str(tmp_path / "a.npz")
    t_ckpt.save(p, {"a": torch.zeros(2, 2)})
    with pytest.raises(ValueError) as tv:
        t_ckpt.restore(p, {"a": torch.zeros(3, 3)})
    with pytest.raises(ValueError) as jv:
        j_ckpt.restore(p, {"a": jnp.zeros((3, 3))})
    assert str(tv.value) == str(jv.value)
    with pytest.raises(KeyError) as tk:
        t_ckpt.restore(p, {"b": torch.zeros(2, 2)})
    with pytest.raises(KeyError) as jk:
        j_ckpt.restore(p, {"b": jnp.zeros((2, 2))})
    assert str(tk.value) == str(jk.value)
    d = tmp_path / "ck"
    assert t_ckpt.latest_step_path(str(d)) is None
    for s in (10, 30, 20):
        t_ckpt.save(str(d / f"step_{s}.npz"), {"a": torch.zeros(1)}, step=s)
    (d / "step_99.npz.tmp").write_bytes(b"")
    (d / "other_50.npz").write_bytes(b"")
    assert (t_ckpt.latest_step_path(str(d))
            == j_ckpt.latest_step_path(str(d)) == str(d / "step_30.npz"))
    assert t_ckpt.latest_step_path(str(d), prefix="other_") == str(d / "other_50.npz")


def _bf16_trees():
    """A tree of bfloat16 (a 0-d one too), float32 and int32 leaves in both
    packages, the bfloat16 leaves rounded from the same float32 values."""
    rng = np.random.default_rng(11)
    f32 = {"w": rng.normal(size=(3, 5)).astype(np.float32),
           "n": {"s": np.float32(rng.normal()),
                 "f": rng.normal(size=(4,)).astype(np.float32)},
           "i": rng.integers(-9, 9, size=(2, 2)).astype(np.int32)}
    bf16 = ("w", "s")
    jtree = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(a, jnp.bfloat16)
        if jpath(p).split("/")[-1] in bf16 else jnp.asarray(a), f32)
    ttree = pytree.tree_map(torch.from_numpy, jax.tree.map(np.asarray, f32))
    ttree["w"] = ttree["w"].to(torch.bfloat16)
    ttree["n"]["s"] = ttree["n"]["s"].to(torch.bfloat16)
    return jtree, ttree


def _assert_bits_equal(got, jtree):
    """The port's tree ``got`` holds ``jtree``'s values bit for bit, in
    JAX's dtypes (bfloat16 read through int16)."""
    tl, jl = pytree.leaves(got), jax.tree.leaves(jtree)
    assert len(tl) == len(jl)
    for g, w in zip(tl, jl):
        w = np.array(w)
        if w.dtype == jnp.bfloat16:
            assert g.dtype == torch.bfloat16
            g, w = g.view(torch.int16), w.view(np.int16)
        assert g.dtype == torch.from_numpy(w).dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)


def test_bf16_checkpoint_files_equal_jax(tmp_path):
    """The port writes a bfloat16 leaf as JAX does (numpy ``|V2``, the
    bit pattern): the two files hold the same arrays key for key, in
    dtype and bytes, and JAX's ``restore`` reads the port's file."""
    jtree, ttree = _bf16_trees()
    tpath, jpath_ = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    t_ckpt.save(tpath, ttree, step=3)
    j_ckpt.save(jpath_, jtree, step=3)
    with np.load(tpath) as a, np.load(jpath_) as b:
        assert list(a.keys()) == list(b.keys())
        assert a["w"].dtype.str == a["n/s"].dtype.str == "|V2"
        for k in a.keys():
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k
    got, meta = j_ckpt.restore(tpath, jtree)
    assert meta == {"step": 3}
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jtree)):
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bf16_checkpoint_restores_bit_for_bit(tmp_path, writer):
    """A bfloat16 tree written by either package restores into the
    port's bfloat16 targets bit for bit (JAX's ``restore`` would return
    the raw ``|V2`` arrays: a departure on purpose)."""
    jtree, ttree = _bf16_trees()
    path = str(tmp_path / "c.npz")
    if writer == "jax":
        j_ckpt.save(path, jtree, step=1)
    else:
        t_ckpt.save(path, ttree, step=1)
    target = pytree.tree_map(torch.zeros_like, ttree)
    got, meta = t_ckpt.restore(path, target)
    assert meta == {"step": 1}
    _assert_bits_equal(got, jtree)


@pytest.mark.parametrize("case", ["float32_target", "numpy_target",
                                  "four_bytes"])
def test_raw_array_refused(tmp_path, case):
    """A raw ``|V…`` array restores only into a bfloat16 target and only
    at 2 bytes an item; otherwise ``ValueError`` names its key."""
    path = str(tmp_path / "c.npz")
    raw = np.zeros((2, 3), np.float32)
    if case == "four_bytes":
        np.savez(path, w=raw.view("V4"))
        target = {"w": torch.zeros(2, 3, dtype=torch.bfloat16)}
    else:
        t_ckpt.save(path, {"w": torch.zeros(2, 3, dtype=torch.bfloat16)})
        target = {"w": torch.zeros(2, 3) if case == "float32_target"
                  else np.zeros((2, 3), np.float32)}
    with pytest.raises(ValueError, match=r"^w: raw \|V[24] array"):
        t_ckpt.restore(path, target)


# ---- the token pipeline and the ERA dedup filter -----------------------------

def test_batch_at_step_equal():
    for seed, step in ((0, 0), (0, 7), (3, 12345)):
        jc = j_tokens.TokenPipelineConfig(vocab=151_936, batch=3, seq_len=9, seed=seed)
        tc = t_tokens.TokenPipelineConfig(vocab=151_936, batch=3, seq_len=9, seed=seed)
        got, want = t_tokens.batch_at_step(tc, step), j_tokens.batch_at_step(jc, step)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


def _planted_batch() -> np.ndarray:
    """``examples/corpus_index.py``'s batch: rows 5 and 11 copy row 2."""
    cfg = t_tokens.TokenPipelineConfig(vocab=32_000, batch=16, seq_len=256, seed=0)
    seqs = t_tokens.batch_at_step(cfg, 0)["tokens"].copy()
    seqs[5, 50:178] = seqs[2, 50:178]
    seqs[11, 0:128] = seqs[2, 50:178]
    return seqs


@pytest.mark.parametrize("case", ["planted", "random"])
def test_dedup_mask_equals_jax(case):
    if case == "planted":
        seqs, kw = _planted_batch(), dict(min_repeat=64)
    else:
        rng = np.random.default_rng(5)
        seqs = rng.integers(0, 1000, size=(8, 128), dtype=np.int32)
        seqs[3, 10:60] = seqs[6, 40:90]
        kw = dict(min_repeat=16, mem_budget=1 << 14)
    got = t_tokens.dedup_mask(seqs, device="cpu", **kw)
    want = j_tokens.dedup_mask(seqs, **kw)
    assert got.dtype == np.bool_ and got.shape == (len(seqs),)
    np.testing.assert_array_equal(got, want)
    assert not got.all()


# ---- the train driver ---------------------------------------------------------

TRAIN_KW = dict(steps=4, batch=2, seq=16, log_every=1)


@pytest.fixture
def jax_init(monkeypatch):
    """The port's ``train`` starts from the JAX driver's parameters
    (``init_params(PRNGKey(0), …)``; the port draws its own otherwise)."""
    def init(seed, cfg, dtype, device):
        jp = JT.init_params(jax.random.PRNGKey(0), j_smoke(j_get(cfg.name)),
                            jnp.float32)
        return T.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device)
    monkeypatch.setattr(t_train.T, "init_params", init)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX driver: 4 steps straight, and 2 steps + a checkpoint, then a
    resumed run to step 4."""
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    _, straight = j_train.train("qwen3-1.7b", **TRAIN_KW)
    _, first = j_train.train("qwen3-1.7b", **{**TRAIN_KW, "steps": 2},
                             ckpt_dir=d, ckpt_every=2)
    _, resumed = j_train.train("qwen3-1.7b", **TRAIN_KW, ckpt_dir=d,
                               ckpt_every=100)
    return {"straight": straight, "first": first, "resumed": resumed, "dir": d}


def assert_losses(got, want):
    assert len(got) == len(want)
    np.testing.assert_allclose(got[:1], want[:1], rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=LATER_RTOL)


def test_train_losses_equal_jax(jax_runs, jax_init, no_flash):
    params, losses = t_train.train("qwen3-1.7b", **TRAIN_KW, device="cpu")
    assert all(np.isfinite(losses))
    assert_losses(losses, jax_runs["straight"])
    assert all(p.device.type == "cpu" for p in pytree.leaves(params))


def test_train_resume_equals_jax(jax_runs, jax_init, tmp_path, capsys):
    d = str(tmp_path / "ck")
    _, straight = t_train.train("qwen3-1.7b", **TRAIN_KW, device="cpu")
    _, first = t_train.train("qwen3-1.7b", **{**TRAIN_KW, "steps": 2},
                             ckpt_dir=d, ckpt_every=2, device="cpu")
    capsys.readouterr()
    _, resumed = t_train.train("qwen3-1.7b", **TRAIN_KW, ckpt_dir=d,
                               ckpt_every=100, device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"resumed from {d}/step_2.npz at step 2"
    assert sorted(os.listdir(d)) == ["step_2.npz"]
    assert_losses(first, jax_runs["first"])
    assert_losses(resumed, jax_runs["resumed"])
    # the CPU run is deterministic: the resumed losses are the straight ones
    np.testing.assert_allclose(first + resumed, straight, rtol=1e-6)
    # the port resumes from the JAX driver's checkpoint
    d2 = str(tmp_path / "from_jax")
    os.makedirs(d2)
    shutil.copy(os.path.join(jax_runs["dir"], "step_2.npz"), d2)
    _, from_jax = t_train.train("qwen3-1.7b", **TRAIN_KW, ckpt_dir=d2,
                                ckpt_every=100, device="cpu")
    assert_losses(from_jax, jax_runs["resumed"])


def test_train_bf16_resume_exact(tmp_path, capsys):
    """``train`` in bfloat16 checkpoints and resumes: 2 steps, a
    checkpoint and a resumed run to step 4 give the straight run's losses
    exactly (the restore is bit for bit and the CPU run deterministic),
    and the checkpoint holds bfloat16 parameters as ``|V2``.  The port
    draws its own bfloat16 parameters."""
    d = str(tmp_path / "ck")
    kw = {**TRAIN_KW, "dtype": torch.bfloat16, "device": "cpu"}
    _, straight = t_train.train("qwen3-1.7b", **kw)
    _, first = t_train.train("qwen3-1.7b", **{**kw, "steps": 2},
                             ckpt_dir=d, ckpt_every=2)
    capsys.readouterr()
    params, resumed = t_train.train("qwen3-1.7b", **kw, ckpt_dir=d,
                                    ckpt_every=100)
    assert capsys.readouterr().out.splitlines()[0] == \
        f"resumed from {d}/step_2.npz at step 2"
    assert all(np.isfinite(straight))
    assert first + resumed == straight
    assert all(p.dtype == torch.bfloat16 for p in pytree.leaves(params))
    with np.load(os.path.join(d, "step_2.npz")) as f:
        assert f["0/embed"].dtype.str == "|V2"
        assert f["1/m/embed"].dtype == np.float32


@pytest.mark.parametrize("arch", UNPORTED + ["internvl2-2b"])
def test_unported_families_raise(arch, jax_init, no_flash):
    """The families ported after this module's: the driver trains the moe
    (GQA, MLA), ssm and hybrid archs with the JAX driver's losses from
    its parameters, and refuses the encdec and frontend archs with the
    JAX driver's ``SystemExit``."""
    cfg = smoke_config(get_config(arch))
    if cfg.family == "encdec" or cfg.frontend:
        with pytest.raises(SystemExit, match="decoder-only") as got:
            t_train.train(arch, steps=1, device="cpu")
        with pytest.raises(SystemExit) as want:
            j_train.train(arch, steps=1)
        assert str(got.value) == str(want.value)
        return
    _, want = j_train.train(arch, **TRAIN_KW)
    params, got = t_train.train(arch, **TRAIN_KW, device="cpu")
    assert all(np.isfinite(got))
    assert_losses(got, want)
    assert all(p.device.type == "cpu" for p in pytree.leaves(params))


def test_train_mesh_and_device():
    with pytest.raises(ValueError, match="pass a DeviceMesh"):
        t_train.train("qwen3-1.7b", steps=1, mesh="prod", device="cpu")
    with pytest.raises(ValueError, match="Number of devices 1 must be"):
        t_train.main(["--mesh", "prod", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):  # no CPU fallback
            t_train.train("qwen3-1.7b", steps=1)

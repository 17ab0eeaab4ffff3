"""PyTorch port vs the JAX package: the parts of the families' training
beside ``tests/test_torch_family_train.py`` (whose models, batches and
tolerances this module shares), on the CPU:

* three ``make_train_step`` steps of every family against JAX's;
* the MoE gradients with a router forced to drop assignments;
* the ``"dots"`` remat policy: no product with a batch saved;
* the scan's backward (:class:`repro_torch.models.ssm.SSMScan`):
  ``torch.autograd.gradcheck`` in float64 at S = 1, 2, 3, 7 and 64 with
  the decay full and broadcast, its gradients against ``jax.grad`` of
  JAX's ``_ssm_scan``, what it saves (``saved_tensors_hooks``), nothing
  under ``torch.no_grad``, its recompute under ``torch.utils.checkpoint``
  (plain and the ``"dots"`` selective context), and the SSM blocks'
  gradients by row groups;
* the registry's ``input_specs`` (every arch and shape) and
  ``concrete_inputs`` (every arch at a small shape of each kind) against
  JAX's.

Three steps: the first loss ``rtol`` 1e-6 (seamless: the float64 rule of
the other module), the gradient norm 2e-3, later losses 5e-4 and the
parameters ``2 * lr`` a step, as ``tests/test_torch_train.py``.  The scan
in float32 against JAX: ``rtol`` 1e-4, ``atol`` 1e-4 of the largest
reference value (``tests/test_torch_families.py``'s).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import checkpoint as ckpt

from repro.launch import steps as j_steps
from repro.models import registry as j_registry
from repro.models import ssm as jssm
from repro.models.config import SHAPES as J_SHAPES
from repro.models.config import ShapeConfig as JShape
from repro.models.config import smoke_config as j_smoke
from repro.optim import adamw as j_adamw
from repro_torch import pytree
from repro_torch.launch import steps as t_steps
from repro_torch.models import nn as tnn
from repro_torch.models import registry as t_registry
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as T
from repro_torch.models.config import SHAPES, ShapeConfig, smoke_config
from repro_torch.optim import adamw as t_adamw
from test_torch_families import assert_close
from test_torch_family_train import (B, CASES, GRAD_ATOL, LOSS_RTOL, Pair,
                                     assert_f64_rule, both)
from test_torch_family_train import no_flash  # noqa: F401  (a fixture)
from test_torch_train import LATER_RTOL, assert_tree_close


# ---- three train steps ------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_three_train_steps_match_jax(case, no_flash):
    """Three steps from the same parameters on the same batches: each
    step's loss, gradient norm and lr, and the parameters after them.
    Seamless' trajectories part after one step in float32 (its gradient
    norm reaches ~700 by the third step and both packages' float32 runs
    lie further than that from a float64 run), so each of its steps
    starts from JAX's parameters and moments, and the step is held by the
    float64 rule against JAX's step in float64 from the same state."""
    _, arch, replace = case
    pair = Pair(arch, seed=2, **replace)
    cfg = dict(lr=1e-3, warmup_steps=2, total_steps=5)
    jstep = j_steps.make_train_step(pair.jcfg, j_adamw.AdamWConfig(**cfg))
    tstep = t_steps.make_train_step(pair.cfg, t_adamw.AdamWConfig(**cfg))
    jp, js = pair.jp, j_adamw.init(pair.jp)
    tp, ts = pair.tp, t_adamw.init(pair.tp)
    for i in range(3):
        batch = pair.batch(seed=10 + i)
        jb, tb = both(batch)
        if pair.f64:  # from JAX's state, against its float64 step
            tp = T.params_from_numpy(jax.tree.map(np.asarray, jp), pair.cfg,
                                     "cpu")
            ts = t_adamw.AdamWState(*(pytree.tree_map(
                lambda a: torch.from_numpy(np.array(a)), x) for x in js))
            with jax.enable_x64(True):
                up = lambda a: jnp.asarray(np.asarray(a), jnp.float64
                                           if a.dtype == jnp.float32 else a.dtype)
                rp, _, rm = jax.tree.map(np.asarray, jax.jit(jstep)(
                    jax.tree.map(up, jp), js, jax.tree.map(up, batch)))
        jp_in = jp
        jp, js, jm = jax.jit(jstep)(jp, js, jb)
        tp, ts, tm = tstep(tp, ts, tb)
        rtol = LOSS_RTOL if i == 0 else LATER_RTOL
        if pair.f64:
            assert_f64_rule(float(tm["loss"]), float(jm["loss"]), rm["loss"],
                            LOSS_RTOL * abs(float(rm["loss"])), f"loss {i}")
            assert_f64_rule(float(tm["grad_norm"]), float(jm["grad_norm"]),
                            rm["grad_norm"], GRAD_ATOL * rm["grad_norm"],
                            f"grad_norm {i}")
            for (path, g), w, r, w0 in zip(
                    pytree.leaves_with_paths(tp), jax.tree.leaves(jp),
                    jax.tree.leaves(rp), jax.tree.leaves(jp_in)):
                assert_f64_rule(g.numpy() - np.asarray(w0),
                                np.asarray(w) - np.asarray(w0),
                                r - np.asarray(w0), 2 * cfg["lr"],
                                f"step {i} {'/'.join(path)}")
        else:
            np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                       rtol=rtol)
            np.testing.assert_allclose(float(tm["grad_norm"]),
                                       float(jm["grad_norm"]), rtol=GRAD_ATOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-7)
    if not pair.f64:
        assert_tree_close(tp, jp, atol=3 * 2 * cfg["lr"])


# ---- MoE: dropped assignments and the "dots" policy -------------------------

@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "deepseek-v2-236b"])
def test_moe_gradients_with_dropped_assignments(arch, no_flash, monkeypatch):
    """The first MoE layer's router forced onto expert 0, so that expert's
    capacity drops assignments: a constant feature added to every
    embedding row (dimension 0 of the normalized hidden state is then
    ~2.5 at that layer for every token) and expert 0's router weight on
    it raised, so its logit rises by about 15 (the other probabilities
    stay far above the float32 denormals that JAX's CPU flushes to zero).
    The loss and every gradient leaf against JAX's; the experts left
    without a kept assignment have zero gradients on both sides."""
    p = Pair(arch, seed=6)
    batch = p.batch(seed=12)
    t = B * batch["tokens"].shape[1]
    cap = max(int(np.ceil(t * p.cfg.top_k / p.cfg.n_experts
                          * p.cfg.capacity_factor)), 4)
    jp = jax.tree.map(np.array, p.jp)
    jp["embed"][:, 0] += 4.0
    jp["layers"]["moe"]["router"][0, 0, 0] += 6.0
    p.jp = jax.tree.map(jnp.asarray, jp)
    p.tp = T.params_from_numpy(jp, p.cfg, "cpu")

    routed = []
    real = tnn.moe_route

    def recording(prm, xt, cfg_):
        probs, vals, ids = real(prm, xt, cfg_)
        routed.append((probs.detach(), ids))
        return probs, vals, ids
    monkeypatch.setattr(tnn, "moe_route", recording)

    jb, tb = both(batch)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        j_steps.make_loss_fn(p.jcfg)))(p.jp, jb)
    loss, grads = t_steps.value_and_grad(t_steps.make_loss_fn(p.cfg))(p.tp, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    assert_tree_close(grads, jgrads, atol_rel=GRAD_ATOL)
    n_moe = p.cfg.n_layers - p.cfg.n_dense_layers
    for probs, _ in routed[:n_moe]:  # the forward's calls, layer order
        assert float(probs.min()) > 1e-30  # no denormal for JAX to flush
    ids = routed[0][1]
    assert (ids[:, 0] == 0).all()  # the first MoE layer's router forced
    flat = ids.reshape(-1).numpy()
    slot = np.array([np.sum(flat[:i] == e) for i, e in enumerate(flat)])
    assert (slot >= cap).sum() > 0  # and its capacity drops assignments
    for key in ("w_gate", "w_up", "w_down"):
        jz = np.asarray(jgrads["layers"]["moe"][key])
        tz = grads["layers"]["moe"][key].numpy()
        np.testing.assert_array_equal(
            np.abs(tz).reshape(*tz.shape[:2], -1).max(-1) == 0,
            np.abs(jz).reshape(*jz.shape[:2], -1).max(-1) == 0)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "deepseek-v2-236b",
                                  "falcon-mamba-7b", "zamba2-2.7b"])
def test_dots_policy_saves_no_batched_product(arch, monkeypatch):
    """``remat_policy="dots"`` (JAX's ``dots_with_no_batch_dims_saveable``)
    saves the weight products and no product with a batch: not the
    expert ``bmm`` over E, the SSM contractions over (B, S) or
    attention's; the scan and every other op are recomputed."""
    p = Pair(arch)
    seen = []
    real = T._saves_dots

    def spying(ctx, op, *args, **kwargs):
        policy = real(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            shape = getattr(args[0], "shape", ()) if args else ()
            seen.append((op, tuple(shape), policy))
        return policy
    monkeypatch.setattr(T, "_saves_dots", spying)
    _, tb = both(p.batch())
    loss, _ = t_steps.value_and_grad(
        t_steps.make_loss_fn(p.cfg, remat_policy="dots"))(p.tp, tb)
    assert np.isfinite(float(loss))
    must = ckpt.CheckpointPolicy.MUST_SAVE
    saved = [(op, shp) for op, shp, pol in seen if pol == must]
    assert saved and all(op is torch.ops.aten.mm.default or shp[0] == 1
                         for op, shp in saved), saved
    bmm = [shp for op, shp, pol in seen if op is torch.ops.aten.bmm.default
           and shp[0] > 1]
    assert bmm  # batched products ran and were left to recompute
    if p.cfg.family == "moe":
        assert any(shp[0] == p.cfg.n_experts for shp in bmm)


# ---- the scan's backward ----------------------------------------------------

def _scan_inputs(s: int, heads: bool, dtype, seed: int = 0, lead: int = 2):
    """(a, b) with ``a`` in [0.5, 1): ``heads`` a (B,S,NH,1,1) decay
    broadcast against a (B,S,NH,HD,N) drive (Mamba-2), else both
    (B,S,C,N) (Mamba-1)."""
    rng = np.random.default_rng(seed)
    shape_b = (lead, s, 2, 3, 2) if heads else (lead, s, 3, 2)
    shape_a = (lead, s, 2, 1, 1) if heads else shape_b
    a = rng.uniform(0.5, 1.0, size=shape_a)
    b = rng.normal(size=shape_b)
    return a.astype(dtype), b.astype(dtype)


@pytest.mark.parametrize("s", [1, 2, 3, 7, 64])
@pytest.mark.parametrize("heads", [False, True])
def test_scan_gradcheck_float64(s, heads):
    a, b = _scan_inputs(s, heads, np.float64, seed=s, lead=1 if s > 7 else 2)
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    assert torch.autograd.gradcheck(tssm.SSMScan.apply, (ta, tb))
    assert tssm._ssm_scan(ta, tb).grad_fn.name() == "SSMScanBackward"


@pytest.mark.parametrize("s", [64, 1000])
@pytest.mark.parametrize("heads", [False, True])
def test_scan_gradients_match_jax(s, heads):
    """The gradients of ``sum(h * w)`` with respect to ``a`` and ``b``
    against ``jax.grad`` of JAX's ``_ssm_scan`` (its ``associative_scan``
    differentiated by JAX), float32."""
    a, b = _scan_inputs(s, heads, np.float32, seed=s + heads)
    w = np.random.default_rng(5).normal(size=b.shape).astype(np.float32)
    want = jax.jit(jax.grad(lambda x, y: jnp.sum(jssm._ssm_scan(x, y) * w),
                            argnums=(0, 1)))(jnp.asarray(a), jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    (tssm._ssm_scan(ta, tb) * torch.from_numpy(w)).sum().backward()
    assert_close(ta.grad, want[0])
    assert_close(tb.grad, want[1])


def _saved_bytes(fn) -> tuple:
    """(tensors, bytes) that autograd saves while ``fn`` runs (each
    storage counted once), and ``fn``'s result."""
    seen = {}

    def pack(t):
        seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return len(seen), sum(seen.values()), out


@pytest.mark.parametrize("s", [16, 256])
def test_scan_saves_inputs_not_passes(s):
    """The Function keeps ``a`` and ``h`` (one tensor the size of ``b``):
    at most 3x the inputs' bytes whatever the number of passes (4 at S =
    16, 8 at S = 256); under ``torch.no_grad`` or on inputs that need no
    gradient it saves nothing."""
    a, b = _scan_inputs(s, False, np.float32)
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    n, nbytes, h = _saved_bytes(lambda: tssm._ssm_scan(ta * 1.0, tb * 1.0))
    assert nbytes <= 3 * (a.nbytes + b.nbytes) and n <= 3
    h.sum().backward()
    assert ta.grad is not None and tb.grad is not None
    with torch.no_grad():
        assert _saved_bytes(lambda: tssm._ssm_scan(ta, tb))[:2] == (0, 0)
    plain = torch.from_numpy(a), torch.from_numpy(b)
    n, nbytes, h = _saved_bytes(lambda: tssm._ssm_scan(*plain))
    assert (n, nbytes) == (0, 0) and h.grad_fn is None
    torch.testing.assert_close(h, tssm._doubling_scan(*plain), rtol=0, atol=0)


@pytest.mark.parametrize("policy", ["plain", "dots"])
def test_scan_recomputes_under_checkpoint(policy, monkeypatch):
    """Under non-reentrant ``torch.utils.checkpoint`` (plain, and the
    ``"dots"`` selective context of ``forward_train``) the backward runs
    the Function's forward again and gives the gradients of a run
    without checkpointing."""
    a, b = _scan_inputs(33, True, np.float32, seed=4)
    calls = []
    real = tssm._doubling_scan

    def counting(x, y):
        calls.append(y.shape[1])
        return real(x, y)
    monkeypatch.setattr(tssm, "_doubling_scan", counting)

    def run(x, y):
        return torch.tanh(tssm._ssm_scan(torch.sigmoid(x), y * 2.0))

    def grads(wrap):
        ta = torch.from_numpy(a).requires_grad_(True)
        tb = torch.from_numpy(b).requires_grad_(True)
        wrap(ta, tb).square().sum().backward()
        return ta.grad, tb.grad

    want = grads(run)
    assert len(calls) == 1
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, T._saves_dots)
    got = grads(lambda x, y: ckpt.checkpoint(run, x, y, use_reentrant=False,
                                             **kw))
    assert len(calls) == 3  # the checkpointed forward and its recompute
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b"])
def test_ssm_block_gradients_by_row_groups(arch, monkeypatch):
    """Past ``SCAN_BYTES`` a tensor the SSM blocks scan groups of batch
    rows under autograd too: the same gradients as the whole batch."""
    cfg = smoke_config(t_registry.get_config(arch))
    tp = T.init_params(4, cfg, torch.float32, "cpu")
    p = T._layer(tp["layers"], 0)["ssm"]
    fn = tssm.mamba2 if cfg.ssm == "mamba2" else tssm.mamba1
    x = torch.randn((3, 9, cfg.d_model),
                    generator=torch.Generator().manual_seed(2))

    def grads():
        leaves = [v.detach().requires_grad_(True) for v in p.values()]
        xx = x.clone().requires_grad_(True)
        out, _ = fn(dict(zip(p, leaves)), xx, cfg)
        return torch.autograd.grad(out.square().sum(), leaves + [xx])

    whole = grads()
    monkeypatch.setattr(tssm, "SCAN_BYTES", 1)
    for g, w in zip(grads(), whole):
        torch.testing.assert_close(g, w, rtol=1e-5,
                                   atol=1e-6 * float(w.abs().max()))


# ---- the registry's inputs --------------------------------------------------

@pytest.mark.parametrize("arch", sorted(t_registry.ARCHS))
def test_input_specs_match_jax(arch):
    """Keys (in order), shapes and dtypes of every shape kind at every
    ``SHAPES`` entry, at the default bf16 and in float32; the stand-ins
    hold no storage."""
    cfg, jcfg = t_registry.get_config(arch), j_registry.get_config(arch)
    assert sorted(SHAPES) == sorted(J_SHAPES)
    for name in SHAPES:
        for tdt, jdt in ((None, None), (torch.float32, jnp.float32)):
            got = (t_registry.input_specs(cfg, SHAPES[name]) if tdt is None
                   else t_registry.input_specs(cfg, SHAPES[name], dtype=tdt))
            want = (j_registry.input_specs(jcfg, J_SHAPES[name]) if jdt is None
                    else j_registry.input_specs(jcfg, J_SHAPES[name], dtype=jdt))
            assert list(got) == list(want), (arch, name)
            for k, v in got.items():
                assert v.device.type == "meta"
                assert tuple(v.shape) == tuple(want[k].shape), (arch, name, k)
                assert str(v.dtype).split(".")[1] == str(want[k].dtype), k


@pytest.mark.parametrize("arch", sorted(t_registry.ARCHS))
def test_concrete_inputs_match_jax(arch):
    """The same seed gives JAX's arrays at a small shape of each kind
    (the smoke config: frames and patches of a few rows)."""
    cfg = smoke_config(t_registry.get_config(arch))
    jcfg = j_smoke(j_registry.get_config(arch))
    for kind, s, b in (("train", 12, 2), ("prefill", 9, 3), ("decode", 9, 2)):
        for seed in (0, 7):
            got = t_registry.concrete_inputs(cfg, ShapeConfig("x", kind, s, b),
                                             seed=seed, device="cpu")
            want = j_registry.concrete_inputs(jcfg, JShape("x", kind, s, b),
                                              seed=seed)
            assert list(got) == list(want)
            for k, v in got.items():
                assert v.device.type == "cpu"
                assert str(v.dtype).split(".")[1] == str(want[k].dtype), k
                np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))

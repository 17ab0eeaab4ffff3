"""PyTorch port vs the JAX package: LM training of the moe (GQA and MLA),
ssm, hybrid and encdec families: ``forward_train`` and the loss with
every gradient leaf.

The same parameters (the JAX package's ``init_params``, carried across by
``transformer.params_from_numpy``) and the same batches (numpy seeds) go
through ``forward_train`` and ``jax.value_and_grad`` of ``make_loss_fn``
and its port on the CPU, in float32, at the smoke widths of
``falcon-mamba-7b`` (Mamba-1), ``zamba2-2.7b`` (Mamba-2 chunks with one
shared attention block), ``seamless-m4t-medium`` (encoder-decoder),
``phi3.5-moe-42b-a6.6b`` (MoE, GQA) and ``deepseek-v2-236b`` (MoE with MLA
and a leading dense layer), plus deepseek with ``q_lora = 0`` (MLA's
other query branch), under remat off and on and both policies.  Train
steps, dropped MoE assignments, the ``"dots"`` policy, the scan's backward
and the registry's inputs: ``tests/test_torch_family_train_parts.py``.

Tolerances:

* logits ``rtol`` 1e-4, ``atol`` 1e-4 of the largest logit (those of
  ``tests/test_torch_families.py``); the aux loss ``rtol`` 1e-6;
* the loss ``rtol`` 1e-6 and each gradient leaf ``atol`` 2e-3 of the
  leaf's largest entry (``tests/test_torch_train.py``'s);
* seamless instead against a float64 run of the JAX package
  (``jax.enable_x64``): the port's float32 no further from it than
  ``F64_FACTOR`` times JAX's own float32 plus the atol above (1e-4 of the
  largest logit, 1e-6 of the loss, 2e-3 of a leaf's largest gradient).
  Its training batch feeds the encoder as many frames as tokens (16), and
  with no qk-norm the cross-attention over the encoder's states is near
  one-hot, so float32 rounding grows ~4000-fold: over five parameter
  seeds JAX's float32 lies up to 1.3e-3 of the largest logit, 3.0e-6 of
  the loss and 2.0e-2 of a leaf's largest gradient from its float64 run
  (the port's float32 up to 3.0e-4, 1.9e-6 and 4.6e-3), so the two
  float32 runs differ by up to 6.9e-4 of the largest logit and 1.5e-2 of
  a leaf, past the tolerances above.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as j_steps
from repro.models import transformer as JT
from repro.models.config import smoke_config as j_smoke
from repro.models.registry import get_config as j_get
from repro_torch import pytree
from repro_torch.launch import steps as t_steps
from repro_torch.models import nn as tnn
from repro_torch.models import transformer as T
from repro_torch.models.config import smoke_config
from repro_torch.models.registry import get_config
from test_torch_train import assert_tree_close, jpath

# (case id, arch, config fields replaced in both packages)
CASES = [("falcon-mamba-7b", "falcon-mamba-7b", {}),
         ("zamba2-2.7b", "zamba2-2.7b", {}),
         ("seamless-m4t-medium", "seamless-m4t-medium", {}),
         ("phi3.5-moe-42b-a6.6b", "phi3.5-moe-42b-a6.6b", {}),
         ("deepseek-v2-236b", "deepseek-v2-236b", {}),
         ("deepseek-v2-236b-q_lora0", "deepseek-v2-236b", {"q_lora": 0})]
B, S = 2, 16
LOGIT_RTOL, LOGIT_ATOL = 1e-4, 1e-4  # ATOL: a share of the largest logit
LOSS_RTOL = 1e-6
GRAD_ATOL = 2e-3  # a share of each gradient leaf's largest entry
F64_FACTOR = 2.0  # seamless: the port's float32 against JAX's, both vs f64


class Pair:
    """One smoke model in both packages, on the same parameters."""

    def __init__(self, arch: str, seed: int = 1, **replace):
        self.jcfg = dataclasses.replace(j_smoke(j_get(arch)), **replace)
        self.cfg = dataclasses.replace(smoke_config(get_config(arch)),
                                       **replace)
        self.jp = JT.init_params(jax.random.PRNGKey(seed), self.jcfg,
                                 jnp.float32)
        self.tp = T.params_from_numpy(jax.tree.map(np.asarray, self.jp),
                                      self.cfg, "cpu")

    @property
    def f64(self) -> bool:
        """Whether the float64-anchored rule holds this model (seamless)."""
        return self.cfg.family == "encdec"

    def batch(self, seed: int = 3) -> dict:
        """A training batch of the registry's structure: encdec's frames
        as many as its tokens."""
        rng = np.random.default_rng(seed)
        out = {}
        if self.cfg.family == "encdec":
            out["frontend"] = rng.normal(
                size=(B, S, self.cfg.frontend_dim)).astype(np.float32)
        out["tokens"] = rng.integers(0, self.cfg.vocab, size=(B, S),
                                     dtype=np.int32)
        out["labels"] = rng.integers(0, self.cfg.vocab, size=(B, S),
                                     dtype=np.int32)
        return out

    def jax64(self, fn, batch):
        """``fn(params, batch)`` of the JAX package in float64 (its
        parameters and the batch's frames upcast; ``batch`` a tree of
        numpy arrays), as numpy."""
        with jax.enable_x64(True):
            p64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a),
                                                     jnp.float64), self.jp)
            b64 = jax.tree.map(lambda v: jnp.asarray(
                v, jnp.float64 if v.dtype.kind == "f" else v.dtype), batch)
            return jax.tree.map(np.asarray, jax.jit(fn)(p64, b64))


def both(batch: dict):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def assert_f64_rule(got, want, ref, atol: float, what: str) -> None:
    """The port's ``got`` no further from the float64 ``ref`` than
    ``F64_FACTOR`` times JAX's float32 ``want`` is, plus ``atol``."""
    ref = np.asarray(ref, np.float64)
    err = float(np.abs(np.asarray(got, np.float64) - ref).max())
    err_jax = float(np.abs(np.asarray(want, np.float64) - ref).max())
    assert err <= F64_FACTOR * err_jax + atol, (what, err, err_jax, atol)


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def pair(request):
    _, arch, replace = request.param
    return Pair(arch, **replace)


@pytest.fixture
def no_flash(monkeypatch):
    """Training never reaches the flash_attention kernel (it has no
    backward): any call fails the test."""
    def refuse(*a, **k):
        raise AssertionError("a training call reached flash_attention")
    monkeypatch.setattr(tnn.ops, "flash_attention", refuse)


@pytest.mark.parametrize("remat,policy", [(False, "none"), (True, "none"),
                                          (True, "dots")])
def test_forward_train_logits_and_aux(pair, no_flash, remat, policy):
    batch = pair.batch()
    jb, tb = both(batch)
    want, jaux = jax.jit(lambda p, b: JT.forward_train(
        p, b, pair.jcfg, remat=remat, remat_policy=policy))(pair.jp, jb)
    got, aux = T.forward_train(pair.tp, tb, pair.cfg, remat=remat,
                               remat_policy=policy)
    want = np.asarray(want)
    assert got.shape == want.shape == (B, S, pair.cfg.vocab)
    assert got.dtype == torch.float32
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    assert (float(aux) > 0) == (pair.cfg.family == "moe")
    if pair.f64:
        ref = pair.jax64(lambda p, b: JT.forward_train(p, b, pair.jcfg)[0],
                         batch)
        assert_f64_rule(got.numpy(), want, ref,
                        LOGIT_ATOL * float(np.abs(ref).max()), "logits")
        return
    np.testing.assert_allclose(got.numpy(), want, rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL * float(np.abs(want).max()))


@pytest.mark.parametrize("policy", ["none", "dots"])
def test_loss_and_gradients(pair, no_flash, policy):
    batch = pair.batch(seed=4)
    jb, tb = both(batch)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        j_steps.make_loss_fn(pair.jcfg, remat_policy=policy)))(pair.jp, jb)
    loss, grads = t_steps.value_and_grad(
        t_steps.make_loss_fn(pair.cfg, remat_policy=policy))(pair.tp, tb)
    assert loss.dtype == torch.float32 and not loss.requires_grad
    # every leaf is reached: a graph broken at the scan or the encoder
    # would leave a leaf without gradient
    for path, g in pytree.leaves_with_paths(grads):
        assert bool(g.abs().max() > 0), "/".join(path)
    if not pair.f64:
        np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
        assert_tree_close(grads, jgrads, atol_rel=GRAD_ATOL)
        return
    rloss, rgrads = pair.jax64(jax.value_and_grad(
        j_steps.make_loss_fn(pair.jcfg)), batch)
    assert_f64_rule(float(loss), float(jloss), rloss,
                    LOSS_RTOL * abs(float(rloss)), "loss")
    jl = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    rl = jax.tree_util.tree_flatten_with_path(rgrads)[0]
    tl = list(pytree.leaves_with_paths(grads))
    assert ["/".join(p) for p, _ in tl] == [jpath(p) for p, _ in jl]
    for (path, g), (_, w), (_, r) in zip(tl, jl, rl):
        assert_f64_rule(g.numpy(), w, r, GRAD_ATOL * float(np.abs(r).max()),
                        "/".join(path))

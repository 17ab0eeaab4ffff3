"""PyTorch port vs the JAX package: LM serving of the moe (GQA and MLA),
ssm, hybrid and encdec families.

The same parameters (the JAX package's ``init_params``, carried across by
``transformer.params_from_numpy``) and the same inputs (numpy seeds) go
through ``forward_prefill`` / ``forward_decode`` / ``serve`` (and
``forward_train``) of both packages on the CPU, in float32, at the smoke widths of
``falcon-mamba-7b`` (Mamba-1), ``zamba2-2.7b`` (Mamba-2 chunks with one
shared attention block), ``seamless-m4t-medium`` (encoder-decoder),
``phi3.5-moe-42b-a6.6b`` (MoE, GQA) and ``deepseek-v2-236b`` (MoE with
MLA and a leading dense layer); ``tests/test_torch_family_layers.py``
holds their layers alone.  On the CPU the port's prefill
self-attention from an empty cache and its encoder attention run
``flash_attention_ref`` (the kernel's plain version); the JAX package runs
its ``_sdpa`` throughout.

Tolerance: float32 sums taken in another order (einsum contractions,
the doubling scan against ``associative_scan``'s tree, the kernel's plain
version against a masked softmax) through 2–4 layers.  The encdec
decoder is the worst conditioned: its cross-attention reads encoder
states of magnitude ~35, so its logits are near one-hot and small
differences grow.  Measured, as a share of the largest reference value:
logits at most 2.4e-5 (seamless' decode; 1.0e-5 phi3.5-moe, under 1.3e-6
the others), caches at most 5.1e-5 (seamless' second decoder layer,
where a float64 run of the port puts JAX's float32 5.9e-5 and the port's
1.8e-5 from it).  Asserted as ``rtol=1e-4`` with ``atol`` 1e-4 of the
largest reference value.  MoE routing ids and the dropped assignments are
compared exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as j_serve
from repro.models import transformer as JT
from repro.models.config import smoke_config as j_smoke
from repro.models.registry import ARCHS as J_ARCHS
from repro.models.registry import get_config as j_get
from repro_torch.launch import serve as t_serve
from repro_torch.models import nn as tnn
from repro_torch.models import transformer as T
from repro_torch.models.config import smoke_config
from repro_torch.models.registry import get_config

FAMILIES = ["falcon-mamba-7b", "zamba2-2.7b", "seamless-m4t-medium",
            "phi3.5-moe-42b-a6.6b", "deepseek-v2-236b"]
B, S, MAX_LEN = 2, 16, 32
RTOL, ATOL = 1e-4, 1e-4  # ATOL: a share of the largest reference value


def assert_close(got: torch.Tensor, want) -> None:
    """The module's float32 tolerance (see the docstring)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=ATOL * float(np.abs(want).max()))


def jax_params(cfg_j, cfg_t, seed: int = 1):
    jp = JT.init_params(jax.random.PRNGKey(seed), cfg_j, jnp.float32)
    return jp, T.params_from_numpy(jax.tree.map(np.asarray, jp), cfg_t, "cpu")


class Pair:
    """One smoke model in both packages, on the same parameters."""

    def __init__(self, arch: str, seed: int = 1, **replace):
        self.jcfg = dataclasses.replace(j_smoke(j_get(arch)), **replace)
        self.cfg = dataclasses.replace(smoke_config(get_config(arch)),
                                       **replace)
        self.jp, self.tp = jax_params(self.jcfg, self.cfg, seed)

    def batch(self, rng, s: int = S):
        b = {"tokens": rng.integers(0, self.cfg.vocab, size=(B, s),
                                    dtype=np.int32)}
        if self.cfg.frontend:
            b["frontend"] = rng.normal(size=(B, self.cfg.frontend_len,
                                             self.cfg.frontend_dim)
                                       ).astype(np.float32)
        return b

    def caches(self, max_len: int = MAX_LEN):
        return (JT.init_cache(self.jcfg, B, max_len, jnp.float32),
                T.init_cache(self.cfg, B, max_len, torch.float32, "cpu"))

    def prefill(self, batch, jc, tc):
        jl, jc = jax.jit(lambda p, b, c: JT.forward_prefill(p, b, self.jcfg, c))(
            self.jp, {k: jnp.asarray(v) for k, v in batch.items()}, jc)
        tl, tc = T.forward_prefill(
            self.tp, {k: torch.from_numpy(v) for k, v in batch.items()},
            self.cfg, tc)
        return jl, jc, tl, tc


def assert_caches(tc: dict, jc: dict) -> None:
    assert sorted(tc) == sorted(jc)
    assert tc["pos"] == int(jc["pos"])
    for key in jc:
        if key != "pos":
            assert tc[key].dtype == getattr(torch, str(jc[key].dtype)), key
            assert tuple(tc[key].shape) == jc[key].shape, key
            assert_close(tc[key], jc[key])


@pytest.fixture(scope="module", params=FAMILIES)
def pair(request):
    return Pair(request.param)


def test_specs_match_jax():
    """``model_specs`` of every architecture at its published size: the
    same tree of shapes, axes, inits and scales as the JAX package's."""
    def flat(tree, path=""):
        if hasattr(tree, "shape") and hasattr(tree, "axes"):
            return {path: (tuple(tree.shape), tuple(tree.axes), tree.init,
                           tree.scale)}
        return {k: v for key in tree
                for k, v in flat(tree[key], f"{path}/{key}").items()}

    for arch in J_ARCHS:
        assert flat(T.model_specs(get_config(arch))) == flat(
            JT.model_specs(j_get(arch))), arch


def test_prefill_logits_and_cache(pair):
    rng = np.random.default_rng(3)
    jl, jc, tl, tc = pair.prefill(pair.batch(rng), *pair.caches())
    assert tl.shape == (B, 1, pair.cfg.vocab)
    assert_close(tl, jl)
    assert_caches(tc, jc)


def test_decode_steps(pair):
    rng = np.random.default_rng(5)
    jl, jc, tl, tc = pair.prefill(pair.batch(rng), *pair.caches())
    step = jax.jit(lambda p, t, c: JT.forward_decode(p, t, pair.jcfg, c))
    for _ in range(4):
        tok = rng.integers(0, pair.cfg.vocab, size=(B, 1), dtype=np.int32)
        jl, jc = step(pair.jp, jnp.asarray(tok), jc)
        tl, tc = T.forward_decode(pair.tp, torch.from_numpy(tok), pair.cfg, tc)
        assert_close(tl, jl)
    assert_caches(tc, jc)


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_tokens_match_jax(monkeypatch, arch):
    """``serve``'s greedy tokens equal ``repro.launch.serve``'s on its
    parameters, at steps whose top-2 logit margin exceeds the tolerance
    (asserted, so an argmax tie cannot decide the test).  The encdec
    prompt carries its frontend frames, as JAX's driver draws them."""
    p = Pair(arch, seed=0)  # repro.launch.serve draws PRNGKey(0)
    monkeypatch.setattr(t_serve.T, "init_params",
                        lambda seed, cfg, dtype, device: p.tp)
    kw = dict(smoke=True, batch=B, prompt_len=12, gen=6, seed=4)
    want, _ = j_serve.serve(arch, dtype=jnp.float32, **kw)
    got, stats = t_serve.serve(arch, device="cpu", **kw)
    assert got.dtype == torch.int32 and got.shape == (B, 6)
    assert stats["decode_tok_s"] > 0 and stats["t_prefill_s"] > 0

    rng = np.random.default_rng(4)
    prompt = {"tokens": rng.integers(0, p.cfg.vocab, size=(B, 12),
                                     dtype=np.int32)}
    if p.cfg.family == "encdec" or p.cfg.frontend:
        prompt["frontend"] = rng.normal(size=(B, p.cfg.frontend_len,
                                              p.cfg.frontend_dim))
    jc = JT.init_cache(p.jcfg, B, 12 + 6 + 1, jnp.float32)
    logits, jc = JT.forward_prefill(
        p.jp, {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
               for k, v in prompt.items()}, p.jcfg, jc)
    want = np.asarray(want)
    for j in range(6):
        top = np.sort(np.asarray(logits[:, -1]), axis=-1)
        tol = (ATOL + RTOL) * np.abs(top).max()
        assert (top[:, -1] - top[:, -2]).min() > 2 * tol  # either may err
        np.testing.assert_array_equal(np.argmax(np.asarray(logits[:, -1]), -1),
                                      want[:, j])
        logits, jc = JT.forward_decode(p.jp, jnp.asarray(want[:, j:j + 1]),
                                       p.jcfg, jc)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch,calls", [
    ("falcon-mamba-7b", []), ("deepseek-v2-236b", []),
    ("phi3.5-moe-42b-a6.6b", [True] * 3),   # every layer's GQA attention
    ("zamba2-2.7b", [True] * 2),            # the shared block after each chunk
    ("seamless-m4t-medium", [False] * 2 + [True] * 2),  # encoder, decoder
])
def test_flash_branch(monkeypatch, arch, calls):
    """A prefill runs ``flash_attention`` in every global self-attention
    from the empty cache (causal) and in every encoder layer (full mode);
    MLA, cross-attention and the decode never do."""
    seen = []
    real = tnn.ops.flash_attention

    def counting(q, k, v, *, causal=True):
        seen.append(causal)
        return real(q, k, v, causal=causal)

    monkeypatch.setattr(tnn.ops, "flash_attention", counting)
    p = Pair(arch)
    _, tc = p.caches()
    batch = {k: torch.from_numpy(v)
             for k, v in p.batch(np.random.default_rng(0), 8).items()}
    _, tc = T.forward_prefill(p.tp, batch, p.cfg, tc)
    assert seen == calls
    T.forward_decode(p.tp, torch.zeros((B, 1), dtype=torch.int32), p.cfg, tc)
    assert seen == calls


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_train_matches_jax(arch):
    """``forward_train`` of each family (remat on, the default) on a
    serving batch, the encoder fed the frontend's frames: logits and the
    aux loss against JAX's, never reaching ``flash_attention``.  Its
    gradients and train steps: ``tests/test_torch_family_train.py``."""
    p = Pair(arch)
    batch = p.batch(np.random.default_rng(7))
    want, jaux = jax.jit(lambda prm, b: JT.forward_train(prm, b, p.jcfg))(
        p.jp, {k: jnp.asarray(v) for k, v in batch.items()})
    real = tnn.ops.flash_attention
    tnn.ops.flash_attention = None  # a call would raise
    try:
        got, aux = T.forward_train(
            p.tp, {k: torch.from_numpy(v) for k, v in batch.items()}, p.cfg)
    finally:
        tnn.ops.flash_attention = real
    assert got.shape == (B, S, p.cfg.vocab)
    assert_close(got, want)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)

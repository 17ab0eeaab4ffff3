"""PyTorch port vs the JAX package: LM serving (dense and vlm families).

The same parameters (the JAX package's ``init_params``, carried across by
``transformer.params_from_numpy``) and the same inputs (numpy seeds) go
through ``forward_prefill`` / ``forward_decode`` / ``serve`` of both
packages on the CPU, in float32, at the smoke widths of ``qwen3-1.7b``
(qk_norm, GQA), ``qwen1.5-32b`` (qkv_bias, MHA), ``gemma3-4b`` (sliding
window with global layers, so both attention branches run) and
``internvl2-2b`` (the vlm frontend).  On the CPU the port's prefill
attention of a global layer from an empty cache runs
``flash_attention_ref`` (the kernel's plain version), everything else its
``_sdpa``; the JAX package runs its ``_sdpa`` throughout.

Tolerance: float32 sums taken in another order (einsum contractions,
the kernel's plain version against a masked softmax over the whole cache)
through 2–3 layers, on logits of magnitude ~30–50 (token embeddings are
scaled by sqrt(d_model)).  Measured: at most 2.8e-4 absolute, under
1e-5 of the largest logit; asserted as ``rtol=1e-4`` with ``atol`` 2e-5
of the largest reference value.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as j_serve
from repro.models import transformer as JT
from repro.models.config import SHAPES as J_SHAPES
from repro.models.config import smoke_config as j_smoke
from repro.models.registry import ARCHS as J_ARCHS
from repro.models.registry import cell_is_runnable as j_runnable
from repro.models.registry import get_config as j_get
from repro_torch.launch import serve as t_serve
from repro_torch.models import nn as tnn
from repro_torch.models import transformer as T
from repro_torch.models.config import SHAPES, smoke_config
from repro_torch.models.registry import ARCHS, cell_is_runnable, get_config

ARCH_CASES = ["qwen3-1.7b", "qwen1.5-32b", "gemma3-4b", "internvl2-2b"]
B, S, MAX_LEN = 2, 16, 32


def assert_close(got: torch.Tensor, want) -> None:
    """The module's float32 tolerance (see the docstring)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=2e-5 * float(np.abs(want).max()))


class Pair:
    """One smoke model in both packages, on the same parameters."""

    def __init__(self, arch: str, seed: int = 1):
        self.jcfg = j_smoke(j_get(arch))
        self.cfg = smoke_config(get_config(arch))
        self.jp = JT.init_params(jax.random.PRNGKey(seed), self.jcfg,
                                 jnp.float32)
        self.tp = T.params_from_numpy(jax.tree.map(np.asarray, self.jp),
                                      self.cfg, "cpu")

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


@pytest.fixture(scope="module", params=ARCH_CASES)
def pair(request):
    return Pair(request.param)


def test_configs_registry_match_jax():
    assert sorted(ARCHS) == sorted(J_ARCHS)
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), j_get(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert (dataclasses.asdict(smoke_config(cfg))
                == dataclasses.asdict(j_smoke(jcfg)))
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        for name in SHAPES:
            assert (cell_is_runnable(cfg, SHAPES[name])
                    == j_runnable(jcfg, J_SHAPES[name]))
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-2")


def test_prefill_logits_and_cache(pair):
    rng = np.random.default_rng(3)
    jl, jc, tl, tc = pair.prefill(pair.batch(rng), *pair.caches())
    assert tl.shape == (B, 1, pair.cfg.vocab)
    assert_close(tl, jl)
    assert_close(tc["k"], jc["k"])
    assert_close(tc["v"], jc["v"])
    assert tc["pos"] == int(jc["pos"])


def test_decode_steps(pair):
    rng = np.random.default_rng(5)
    jl, jc, tl, tc = pair.prefill(pair.batch(rng), *pair.caches())
    step = jax.jit(lambda p, t, c: JT.forward_decode(p, t, pair.jcfg, c))
    for _ in range(3):
        tok = rng.integers(0, pair.cfg.vocab, size=(B, 1), dtype=np.int32)
        jl, jc = step(pair.jp, jnp.asarray(tok), jc)
        tl, tc = T.forward_decode(pair.tp, torch.from_numpy(tok), pair.cfg, tc)
        assert_close(tl, jl)
        assert tc["pos"] == int(jc["pos"])
    assert_close(tc["k"], jc["k"])
    assert_close(tc["v"], jc["v"])


def test_chunked_prefill(pair):
    """Two prompt chunks: the second starts at pos 8 and attends over the
    cache through ``_sdpa``, as in the JAX package."""
    rng = np.random.default_rng(7)
    first = pair.batch(rng, 8)
    second = {"tokens": rng.integers(0, pair.cfg.vocab, size=(B, 8),
                                     dtype=np.int32)}
    _, jc, _, tc = pair.prefill(first, *pair.caches())
    jl, jc, tl, tc = pair.prefill(second, jc, tc)
    assert tc["pos"] == int(jc["pos"]) == 8 + 8 + pair.cfg.frontend_len
    assert_close(tl, jl)
    assert_close(tc["k"], jc["k"])


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "internvl2-2b"])
def test_decode_past_cache_end(arch):
    """Decode steps that run past the end of the cache (a vlm ``serve``
    reaches them: both packages size the cache without ``frontend_len``).
    The write start clamps to ``S_max - 1`` as ``dynamic_update_slice``
    clamps it, the validity mask does not.  Logits of every step and both
    caches against JAX, at the module's tolerance (rtol 1e-4, atol 2e-5
    of the largest reference value)."""
    p = Pair(arch)
    rng = np.random.default_rng(11)
    s = 12 + p.cfg.frontend_len
    jl, jc, tl, tc = p.prefill(p.batch(rng, 12), *p.caches(s + 2))
    step = jax.jit(lambda prm, t, c: JT.forward_decode(prm, t, p.jcfg, c))
    for _ in range(5):  # positions s .. s + 4: the last three past the end
        tok = rng.integers(0, p.cfg.vocab, size=(B, 1), dtype=np.int32)
        jl, jc = step(p.jp, jnp.asarray(tok), jc)
        tl, tc = T.forward_decode(p.tp, torch.from_numpy(tok), p.cfg, tc)
        assert_close(tl, jl)
    assert tc["pos"] == int(jc["pos"]) == s + 5
    assert_close(tc["k"], jc["k"])
    assert_close(tc["v"], jc["v"])


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "internvl2-2b"])
def test_chunk_past_cache_end(arch):
    """A second prompt chunk that overflows the cache by 4 slots: its
    write shifts back to end at ``S_max`` (JAX's clamp) instead of failing
    on the shapes.  Logits and both caches against JAX, at the module's
    tolerance; a prompt longer than the whole cache still fails."""
    p = Pair(arch)
    rng = np.random.default_rng(13)
    first = p.batch(rng, 8)
    second = {"tokens": rng.integers(0, p.cfg.vocab, size=(B, 8),
                                     dtype=np.int32)}
    s = 8 + p.cfg.frontend_len
    _, jc, _, tc = p.prefill(first, *p.caches(s + 4))
    jl, jc, tl, tc = p.prefill(second, jc, tc)
    assert tc["pos"] == int(jc["pos"]) == s + 8
    assert_close(tl, jl)
    assert_close(tc["k"], jc["k"])
    assert_close(tc["v"], jc["v"])
    too_long = p.batch(rng, 8)
    jc, tc = p.caches(s - 1)
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        JT.forward_prefill(p.jp, {k: jnp.asarray(v) for k, v in
                                  too_long.items()}, p.jcfg, jc)
    with pytest.raises(RuntimeError):
        T.forward_prefill(p.tp, {k: torch.from_numpy(v) for k, v in
                                 too_long.items()}, p.cfg, tc)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "internvl2-2b"])
def test_serve_tokens_match_jax(monkeypatch, arch):
    """``serve``'s greedy tokens equal ``repro.launch.serve``'s on its
    parameters, at steps whose top-2 logit margin exceeds the
    tolerance (asserted, so an argmax tie cannot decide the test)."""
    p = Pair(arch, seed=0)  # repro.launch.serve draws PRNGKey(0)
    monkeypatch.setattr(t_serve.T, "init_params",
                        lambda seed, cfg, dtype, device: p.tp)
    kw = dict(smoke=True, batch=B, prompt_len=12, gen=6, seed=4)
    want, _ = j_serve.serve(arch, dtype=jnp.float32, **kw)
    got, stats = t_serve.serve(arch, device="cpu", **kw)
    assert got.dtype == torch.int32 and got.shape == (B, 6)
    assert stats["decode_tok_s"] > 0 and stats["t_prefill_s"] > 0

    # the JAX trajectory's logits: every greedy choice has a clear margin
    rng = np.random.default_rng(4)
    prompt = {"tokens": rng.integers(0, p.cfg.vocab, size=(B, 12),
                                     dtype=np.int32)}
    if p.cfg.frontend:
        prompt["frontend"] = rng.normal(size=(B, p.cfg.frontend_len,
                                              p.cfg.frontend_dim))
    jc = JT.init_cache(p.jcfg, B, 12 + 6 + 1, jnp.float32)
    logits, jc = JT.forward_prefill(
        p.jp, {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
               for k, v in prompt.items()}, p.jcfg, jc)
    want = np.asarray(want)
    for j in range(6):
        top = np.sort(np.asarray(logits[:, -1]), axis=-1)
        tol = (2e-5 + 1e-4) * np.abs(top).max()  # atol + rtol, as above
        assert (top[:, -1] - top[:, -2]).min() > 2 * tol  # either may err
        np.testing.assert_array_equal(np.argmax(np.asarray(logits[:, -1]), -1),
                                      want[:, j])
        logits, jc = JT.forward_decode(p.jp, jnp.asarray(want[:, j:j + 1]),
                                       p.jcfg, jc)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch,calls", [("qwen3-1.7b", 3), ("gemma3-4b", 1),
                                        ("internvl2-2b", 3)])
def test_flash_branch(monkeypatch, arch, calls):
    """The prefill from an empty cache runs ``flash_attention`` in every
    global layer (gemma3's smoke model: one global of three), and nothing
    else does: not the decode, not a chunk at ``pos > 0``."""
    seen = []
    real = tnn.ops.flash_attention

    def counting(q, k, v, *, causal=True):
        seen.append((tuple(q.shape), tuple(k.shape), causal))
        return real(q, k, v, causal=causal)

    monkeypatch.setattr(tnn.ops, "flash_attention", counting)
    cfg = smoke_config(get_config(arch))
    params = T.init_params(0, cfg, torch.float32, "cpu")
    cache = T.init_cache(cfg, B, MAX_LEN, torch.float32, "cpu")
    batch = {"tokens": torch.zeros((B, 8), dtype=torch.int32)}
    if cfg.frontend:
        batch["frontend"] = torch.zeros((B, cfg.frontend_len, cfg.frontend_dim))
    _, cache = T.forward_prefill(params, batch, cfg, cache)
    s = 8 + cfg.frontend_len
    hd = cfg.head_dim
    assert seen == [((B, s, cfg.n_heads, hd), (B, s, cfg.n_kv_heads, hd),
                     True)] * calls
    T.forward_decode(params, torch.zeros((B, 1), dtype=torch.int32), cfg, cache)
    T.forward_prefill(params, {"tokens": batch["tokens"]}, cfg, cache)
    assert len(seen) == calls


def test_params_layout_checked():
    p = Pair("qwen3-1.7b")
    tree = jax.tree.map(np.asarray, p.jp)
    assert tuple(p.tp["layers"]["attn"]["wq"].shape) == (
        p.cfg.n_layers, p.cfg.d_model, p.cfg.n_heads, p.cfg.head_dim)
    bad = dict(tree, final_norm=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        T.params_from_numpy(bad, p.cfg, "cpu")
    with pytest.raises(ValueError, match="keys"):
        T.params_from_numpy({k: v for k, v in tree.items() if k != "embed"},
                            p.cfg, "cpu")


def test_init_params_scale_rule():
    """Zeros for norms and biases, 1/sqrt(fan_in) normals elsewhere, the
    embedding at scale 1; same seed, same numbers."""
    cfg = dataclasses.replace(smoke_config(get_config("qwen1.5-32b")),
                              vocab=4096)
    a = T.init_params(0, cfg, torch.float32, "cpu")
    b = T.init_params(0, cfg, torch.float32, "cpu")
    assert torch.equal(a["layers"]["mlp"]["w_down"], b["layers"]["mlp"]["w_down"])
    assert not a["layers"]["attn"]["bq"].any() and not a["final_norm"].any()
    assert abs(float(a["embed"].std()) - 1.0) < 0.02
    w_up = a["layers"]["mlp"]["w_up"]  # fan_in = d_model
    assert abs(float(w_up.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    bf = T.init_params(0, cfg, torch.bfloat16, "cpu")
    assert bf["embed"].dtype == torch.bfloat16

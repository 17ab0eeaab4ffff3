"""PyTorch port vs the JAX package: the layers of the moe (GQA and MLA),
ssm, hybrid and encdec families alone, at their smoke widths in float32
on the CPU: ``moe`` with dropped assignments and tied router
probabilities, ``mla_attention`` without ``q_lora`` and row by row, a moe
model's leading dense layer on the GQA branch, ``_ssm_scan`` at a power
of two and at a length that is not one, the SSM blocks by row groups and
their prefill state against token-by-token decode, and the encoder's
attention (``flash_attention_ref`` in its full mode against JAX's
``_sdpa`` with an all-ones mask), and that the families' modules import no
JAX.  Whole models: ``test_torch_families.py``,
whose tolerance this module asserts (``rtol`` 1e-4, ``atol`` 1e-4 of the
largest reference value; measured here at most 2.4e-7 of it) unless a
test states its own.  Routing ids and dropped assignments are compared
exactly.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import nn as jnn
from repro.models import ssm as jssm
from repro.models import transformer as JT
from repro.models.config import smoke_config as j_smoke
from repro.models.registry import get_config as j_get
from repro_torch.kernels import ref as kref
from repro_torch.models import nn as tnn
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as T
from repro_torch.models.config import smoke_config
from repro_torch.models.registry import get_config
from test_torch_families import ATOL, B, RTOL, Pair, assert_caches, assert_close


def _moe_inputs(cfg, t: int, seed: int):
    """(2, t/2, d) positive inputs: a router column raised by c adds c
    times a positive sum to its logit for every token."""
    rng = np.random.default_rng(seed)
    return np.abs(rng.normal(size=(2, t // 2, cfg.d_model))).astype(np.float32)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "deepseek-v2-236b"])
def test_moe_capacity_drops(arch):
    """The router forced onto expert 0 (its logit raised by at least 20
    for every token; not so far that the other probabilities reach
    float32's denormals, which JAX's CPU flushes to zero and torch keeps),
    so that expert's capacity drops assignments: the ids, which
    assignments drop, the output and the aux loss equal JAX's."""
    p = Pair(arch)
    cfg = p.cfg
    jm = jax.tree.map(lambda a: np.array(a[0]), p.jp["layers"]["moe"])
    x = _moe_inputs(cfg, 64, 11)
    jm["router"][:, 0] += 20.0 / x.sum(-1).min()
    tm = jax.tree.map(torch.from_numpy, jm)

    want_y, want_aux = jnn.moe(jax.tree.map(jnp.asarray, jm), jnp.asarray(x),
                               p.jcfg)
    got_y, got_aux = tnn.moe(tm, torch.from_numpy(x), cfg)

    xt = jnp.asarray(x.reshape(-1, cfg.d_model))
    jprobs = jax.nn.softmax(xt @ jm["router"], axis=-1)
    _, jids = jax.lax.top_k(jprobs, cfg.top_k)
    _, _, tids = tnn.moe_route(tm, torch.from_numpy(x).reshape(-1, cfg.d_model),
                               cfg)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    flat = np.asarray(jids).reshape(-1)
    slot = np.array([np.sum(flat[:i] == e) for i, e in enumerate(flat)])
    cap = max(int(np.ceil(64 * cfg.top_k / cfg.n_experts
                          * cfg.capacity_factor)), 4)
    assert (slot >= cap).sum() > 16  # the capacity drops assignments
    assert_close(got_y, want_y)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)


def test_moe_top_k_ties_keep_the_lower_expert():
    """Equal router probabilities: ``moe_route`` picks the lower expert ids
    first, as ``jax.lax.top_k`` does."""
    cfg = smoke_config(get_config("phi3.5-moe-42b-a6.6b"))
    router = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    router[:, 2] = 1.0
    x = np.ones((5, cfg.d_model), np.float32)
    x[3] = -1.0  # expert 2 last: the others tie
    _, _, ids = tnn.moe_route({"router": torch.from_numpy(router)},
                              torch.from_numpy(x), cfg)
    _, jids = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x @ router), -1),
                            cfg.top_k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert ids[0].tolist() == [2, 0] and ids[3].tolist() == [0, 1]


@pytest.mark.parametrize("cached", [False, True])
def test_mla_without_q_lora(cached):
    """``mla_attention`` with ``q_lora = 0`` (``w_uq`` straight from the
    input), without a cache and over a cache at position 5."""
    cfg_j = dataclasses.replace(j_smoke(j_get("deepseek-v2-236b")), q_lora=0)
    cfg = dataclasses.replace(smoke_config(get_config("deepseek-v2-236b")),
                              q_lora=0)
    specs = T.nn.mla_specs(cfg)
    assert "w_dq" not in specs and specs["w_uq"].shape[0] == cfg.d_model
    jp = jnn.init_params(jax.random.PRNGKey(2), jnn.mla_specs(cfg_j))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(B, 6, cfg.d_model)).astype(np.float32)
    q_pos = np.broadcast_to(np.arange(6, dtype=np.int32) + 5 * cached, (B, 6))
    kw_j = dict(q_pos=jnp.asarray(q_pos))
    kw_t = dict(q_pos=torch.from_numpy(q_pos.copy()))
    if cached:
        c1 = rng.normal(size=(B, 16, cfg.kv_lora)).astype(np.float32)
        c2 = rng.normal(size=(B, 16, cfg.rope_dims)).astype(np.float32)
        kw_j.update(cache=(jnp.asarray(c1), jnp.asarray(c2)), cache_index=5)
        kw_t.update(cache=(torch.from_numpy(c1.copy()),
                           torch.from_numpy(c2.copy())), cache_index=5)
    jy, jc = jnn.mla_attention(jp, jnp.asarray(x), cfg_j, **kw_j)
    ty, tc = tnn.mla_attention(tp, torch.from_numpy(x), cfg, **kw_t)
    assert_close(ty, jy)
    if cached:
        assert_close(tc[0], jc[0])
        assert_close(tc[1], jc[1])
    else:
        assert tc is None and jc is None


def test_mla_attends_row_by_row(monkeypatch):
    """Past ``MLA_LOGIT_BYTES`` MLA attends one batch row at a time: the
    same output as the whole batch at once."""
    cfg = smoke_config(get_config("deepseek-v2-236b"))
    tp = T.nn.init_params(T.nn.mla_specs(cfg), torch.float32, "cpu", seed=3)
    x = torch.randn((3, 7, cfg.d_model), generator=torch.Generator().manual_seed(1))
    q_pos = torch.arange(7, dtype=torch.int32)[None].expand(3, 7)
    whole, _ = tnn.mla_attention(tp, x, cfg, q_pos=q_pos)
    monkeypatch.setattr(tnn, "MLA_LOGIT_BYTES", 1)
    rows, _ = tnn.mla_attention(tp, x, cfg, q_pos=q_pos)
    torch.testing.assert_close(rows, whole, rtol=1e-6, atol=1e-6)


def test_moe_leading_dense_layer_gqa():
    """A moe model with one leading dense layer on the GQA branch: its
    cache is ``d_k``/``d_v`` beside ``k``/``v``; prefill, two decode steps
    and every cache tensor against JAX."""
    p = Pair("phi3.5-moe-42b-a6.6b", n_dense_layers=1)
    assert "dense_layers" in p.tp and p.tp["layers"]["attn"]["wq"].shape[0] == 2
    rng = np.random.default_rng(17)
    jl, jc, tl, tc = p.prefill(p.batch(rng), *p.caches())
    assert {"d_k", "d_v"} <= set(tc)
    assert_close(tl, jl)
    step = jax.jit(lambda prm, t, c: JT.forward_decode(prm, t, p.jcfg, c))
    for _ in range(2):
        tok = rng.integers(0, p.cfg.vocab, size=(B, 1), dtype=np.int32)
        jl, jc = step(p.jp, jnp.asarray(tok), jc)
        tl, tc = T.forward_decode(p.tp, torch.from_numpy(tok), p.cfg, tc)
        assert_close(tl, jl)
    assert_caches(tc, jc)


@pytest.mark.parametrize("s", [64, 1000])
@pytest.mark.parametrize("heads", [False, True])
def test_ssm_scan(s, heads):
    """The doubling scan against JAX's ``associative_scan`` at a power of
    two and at a length that is not one; ``heads``: a (B,S,NH,1,1) decay
    broadcast against a (B,S,NH,HD,N) drive, as Mamba-2 scans."""
    rng = np.random.default_rng(s + heads)
    shape_b = (2, s, 3, 4, 5) if heads else (2, s, 6, 4)
    shape_a = (2, s, 3, 1, 1) if heads else shape_b
    a = rng.uniform(0.5, 1.0, size=shape_a).astype(np.float32)
    b = rng.normal(size=shape_b).astype(np.float32)
    want = jax.jit(jssm._ssm_scan)(jnp.asarray(a), jnp.asarray(b))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = tssm._ssm_scan(ta, tb)
    assert_close(got, want)
    assert np.array_equal(ta.numpy(), a) and np.array_equal(tb.numpy(), b)


def test_ssm_rows_in_groups(monkeypatch):
    """Past ``SCAN_BYTES`` a tensor the SSM blocks scan groups of batch
    rows: the same output and state as the whole batch (up to the
    rounding of products batched over fewer rows: 2.4e-7 measured)."""
    for arch in ("falcon-mamba-7b", "zamba2-2.7b"):
        cfg = smoke_config(get_config(arch))
        tp = T.init_params(4, cfg, torch.float32, "cpu")
        p = T._layer(tp["layers"], 0)["ssm"]
        fn = tssm.mamba2 if cfg.ssm == "mamba2" else tssm.mamba1
        x = torch.randn((3, 9, cfg.d_model),
                        generator=torch.Generator().manual_seed(2))
        whole, st = fn(p, x, cfg, return_state=True)
        monkeypatch.setattr(tssm, "SCAN_BYTES", 1)
        rows, st_rows = fn(p, x, cfg, return_state=True)
        monkeypatch.undo()
        torch.testing.assert_close(rows, whole, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(st_rows[1], st[1], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b"])
@pytest.mark.parametrize("s", [2, 11])
def test_ssm_prefill_state_matches_token_steps(arch, s):
    """``mamba1``/``mamba2`` over a prompt with ``return_state`` against
    the same prompt one token at a time through the decode update from a
    zero state: every output and the final (conv, h) state; S = 2 is
    shorter than the conv window, so the conv state is zero-padded."""
    cfg = smoke_config(get_config(arch))
    tp = T.init_params(5, cfg, torch.float32, "cpu")
    p = T._layer(tp["layers"], 1)["ssm"]
    fn = tssm.mamba2 if cfg.ssm == "mamba2" else tssm.mamba1
    x = torch.randn((B, s, cfg.d_model), generator=torch.Generator().manual_seed(s))
    y, (conv, h) = fn(p, x, cfg, return_state=True)
    cache = T.init_cache(cfg, B, 4, torch.float32, "cpu")
    state = (cache["conv"][0], cache["h"][0])
    steps = []
    for t in range(s):
        out, state = fn(p, x[:, t:t + 1], cfg, state)
        steps.append(out)
    for got, want in ((torch.cat(steps, 1), y), (state[0], conv),
                      (state[1], h)):
        torch.testing.assert_close(got, want, rtol=RTOL,
                                   atol=ATOL * float(want.abs().max()))


def test_encoder_attention_full_mode():
    """The encoder's attention: ``flash_attention_ref`` in its full mode
    against JAX's ``_sdpa`` with an all-ones mask, and the whole
    bidirectional ``attention`` of both packages."""
    rng = np.random.default_rng(23)
    q = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 9, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 9, 2, 16)).astype(np.float32)
    ones = jnp.ones((2, 1, 1, 9, 9), bool)
    want = jnn._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), ones,
                     kv_groups=2)
    got = kref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=False)
    assert_close(got, want)

    p = Pair("seamless-m4t-medium")
    lp_j = jax.tree.map(lambda a: a[0], p.jp["enc_layers"]["attn"])
    lp_t = T._layer(p.tp["enc_layers"], 0)["attn"]
    x = rng.normal(size=(B, 7, p.cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (B, 7))
    jy, _ = jnn.attention(lp_j, jnp.asarray(x), p.jcfg, q_pos=jnp.asarray(pos),
                          bidirectional=True)
    ty, tc = tnn.attention(lp_t, torch.from_numpy(x), p.cfg,
                           q_pos=torch.from_numpy(pos.copy()),
                           bidirectional=True)
    assert tc is None
    assert_close(ty, jy)


def test_family_modules_import_no_jax():
    """The families' modules stand alone: importing them pulls in no JAX
    and nothing of the JAX package."""
    root = Path(__file__).resolve().parents[1]
    code = ("import sys\n"
            "import repro_torch.models.ssm, repro_torch.models.transformer\n"
            "import repro_torch.launch.serve\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root,
                   env={"PYTHONPATH": str(root / "src"),
                        "PATH": os.environ.get("PATH", "/usr/bin:/bin")})

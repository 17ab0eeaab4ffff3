"""PyTorch port vs the JAX package: the batched elastic-range engine.

All six ``PrepareState`` fields must be identical after
``subtree_prepare_batch``, on the grids of ``tests/test_batched_build.py``
and ``tests/test_engine_promotion.py::TestBitIdentity``, under the default
leg (fused sort keys + tail compaction) and the ``REPRO_SORT=lexsort`` and
``REPRO_COMPACT=off`` legs, set through the environment both packages
read.  The port runs on the CPU.  Tolerance: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import prepare as jprep
from repro.kernels import ops as jops
from repro.core.alphabet import ALPHABETS as J_ALPHABETS
from repro.core.api import EraConfig as JConfig
from repro.core.api import EraIndexer as JIndexer
from repro.data.strings import dataset as j_dataset
from repro_torch.core import prepare as tprep
from repro_torch.core.api import EraConfig, EraIndexer
from repro_torch.core.alphabet import ALPHABETS
from repro_torch.core.packing import words_to_numpy
from repro_torch.kernels import ops as tops

FIELDS = ("L", "start", "area", "b_off", "b_c1", "b_c2")
LEGS = {"default": {}, "lexsort": {"REPRO_SORT": "lexsort"},
        "compact_off": {"REPRO_COMPACT": "off"}}
# dense text also runs the byte-key oracle leg (range_gather_packed keys)
DENSE_LEGS = {**LEGS, "byte": {"REPRO_WORD_COMPARE": "byte"}}


def _both(s, alpha_name, mem, packing="auto"):
    kw = dict(memory_bytes=mem, r_bytes=128, build_impl="none",
              packing=packing)
    jix = JIndexer(J_ALPHABETS[alpha_name], JConfig(**kw))
    tix = EraIndexer(ALPHABETS[alpha_name], EraConfig(**kw), device="cpu")
    return jix, tix


def _run(s, alpha_name, mem, packing="auto"):
    jix, tix = _both(s, alpha_name, mem, packing)
    jg = jix.partition(s)
    tg = tix.partition(s)
    cap = jix._capacity(jg)
    assert cap == tix._capacity(tg)
    jst = jprep.subtree_prepare_batch(jix._device_text(s), jg, cap,
                                      jix.config.elastic_config())
    tst = tprep.subtree_prepare_batch(tix._device_text(s), tg, cap,
                                      tix.config.elastic_config())
    return jst, tst, len(jg)


def _assert_fields(jst, tst):
    for field in FIELDS:
        got = getattr(tst, field)
        assert got.dtype == torch.int32, field
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jst, field)),
                                      err_msg=field)


@pytest.mark.parametrize("leg", sorted(DENSE_LEGS))
@pytest.mark.parametrize("alpha,n,mem,packing", [
    ("dna", 900, 1024, "auto"),
    ("dna", 1200, 768, "auto"),            # G > 1, uneven group sizes
    ("protein_class", 700, 2048, "auto"),  # 4-bit words
    ("byte", 450, 4096, "dense"),          # 8-bit words, codes >= 128
])
def test_batched_build_grid(monkeypatch, leg, alpha, n, mem, packing):
    for var, val in DENSE_LEGS[leg].items():
        monkeypatch.setenv(var, val)
    s = J_ALPHABETS[alpha].random_string(n, seed=n + mem)
    jst, tst, _ = _run(s, alpha, mem, packing)
    _assert_fields(jst, tst)


@pytest.mark.parametrize("leg", sorted(LEGS))
@pytest.mark.parametrize("alpha,n,mem,packing", [
    ("protein", 1500, 2048, "auto"),    # 20 symbols: byte text under auto
    ("english", 1200, 4096, "auto"),
    ("byte", 900, 2048, "auto"),        # codes >= 128: unsigned sort (C5)
    ("dna", 1200, 1024, "bytes"),       # byte text for a dense alphabet
])
def test_byte_branch_grid(monkeypatch, leg, alpha, n, mem, packing):
    """The byte-key branch (range_gather_pack + unsigned lexsort +
    lcp_pairs): all six state fields equal JAX's; ``sort_fuse`` does not
    apply there in either package (C7), so the default and lexsort legs
    take the same sort."""
    for var, val in LEGS[leg].items():
        monkeypatch.setenv(var, val)
    s = J_ALPHABETS[alpha].random_string(n, seed=n + mem)
    jst, tst, _ = _run(s, alpha, mem, packing)
    _assert_fields(jst, tst)


@pytest.mark.parametrize("leg", sorted(LEGS))
@pytest.mark.parametrize("name,n,mem", [("protein", 4_000, 1 << 13),
                                        ("byte", 3_000, 1 << 13)])
def test_byte_datasets_grid(monkeypatch, leg, name, n, mem):
    """Planted repeats (deep areas, wide elastic ranges) on byte text."""
    for var, val in LEGS[leg].items():
        monkeypatch.setenv(var, val)
    s, _ = j_dataset(name, n, seed=0)
    jst, tst, g = _run(s, name, mem)
    assert g > 1
    _assert_fields(jst, tst)


def test_byte_device_text_is_the_padded_string():
    s, _ = j_dataset("protein", 900, seed=3)
    jix, tix = _both(s, "protein", 2048)
    text = tix._device_text(s)
    assert text.dtype == torch.uint8
    np.testing.assert_array_equal(text.numpy(), np.asarray(jix._device_text(s)))
    assert text.shape[0] == len(s) + 2 * tix.config.w_max + 8


@pytest.mark.parametrize("leg", sorted(DENSE_LEGS))
@pytest.mark.parametrize("name,n,mem", [("dna", 6_000, 1 << 12),
                                        ("genome", 5_000, 1 << 12)])
def test_bit_identity_grid(monkeypatch, leg, name, n, mem):
    for var, val in DENSE_LEGS[leg].items():
        monkeypatch.setenv(var, val)
    s, _ = j_dataset(name, n, seed=0)
    jst, tst, g = _run(s, "dna", mem)
    assert g > 1
    _assert_fields(jst, tst)


def test_fused_and_oracle_engines_agree_in_port():
    s, _ = j_dataset("genome", 4000, seed=2)
    _, tix = _both(s, "dna", 1 << 12)
    groups = tix.partition(s)
    cap = tix._capacity(groups)
    pt = tix._device_text(s)
    ecfg = tix.config.elastic_config()
    fused = tprep.subtree_prepare_batch(pt, groups, cap, ecfg,
                                        sort_fuse=True, compact=True)
    oracle = tprep.subtree_prepare_batch(pt, groups, cap, ecfg,
                                         sort_fuse=False, compact=False)
    for field in FIELDS:
        assert torch.equal(getattr(fused, field), getattr(oracle, field)), field


@pytest.mark.parametrize("w,f", [(4, 1000), (64, 300), (256, 70),
                                 (512, 5000)])
def test_fused_sort_order_equal(w, f):
    """Multi-lane keys (w * bits > 32) and the one-lane case give the
    JAX lexsort's permutation, rows of equal keys included."""
    rng = np.random.default_rng(w + f)
    bits = 2
    nw = -(-w // 16)
    major = rng.integers(0, 4, size=f).astype(np.int32)
    keys = rng.integers(0, 4, size=(f, nw), dtype=np.uint64).astype(np.uint32)
    keys[::3] = keys[0]  # ties on the window
    keys[5::7, 0] = 0xFFFFFFFF  # high bit set
    tie = rng.integers(0, 3, size=f).astype(np.int32)
    want = jprep._fused_sort_order(jnp.asarray(major), jnp.asarray(keys),
                                   jnp.asarray(tie), w=w, bits=bits, f=f)
    got = tprep._fused_sort_order(
        torch.from_numpy(major)[None], torch.from_numpy(keys.view(np.int32))[None],
        torch.from_numpy(tie)[None], w=w, bits=bits, f=f)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


def test_init_batch_equal():
    s, _ = j_dataset("dna", 3000, seed=1)
    jix, tix = _both(s, "dna", 2048)
    jg, tg = jix.partition(s), tix.partition(s)
    cap = jix._capacity(jg)
    jst = jprep.init_batch(jg, cap)
    tst = tprep.init_batch(tg, cap, device="cpu")
    _assert_fields(jst, tst)
    with pytest.raises(ValueError, match="exceeds capacity"):
        tprep.init_batch(tg, cap - 1, device="cpu")


@pytest.mark.parametrize("maxact,cap", [(1, 1024), (33, 1024), (65, 1024),
                                        (600, 1024), (512, 1024), (1, 16)])
def test_compaction_width_equal(maxact, cap):
    assert tprep.compaction_width(maxact, cap) == jprep.compaction_width(
        maxact, cap)


@pytest.mark.parametrize("n_active", [1, 100, 5000, 1 << 20, 10 ** 8])
def test_elastic_range_equal(n_active):
    for cfg in (dict(), dict(elastic=False, static_w=10)):
        assert (tprep.elastic_range(tprep.ElasticConfig(**cfg), n_active)
                == jprep.elastic_range(jprep.ElasticConfig(**cfg), n_active))


def test_stats_equal():
    s, _ = j_dataset("genome", 3000, seed=4)
    jix, tix = _both(s, "dna", 2048)
    jg, tg = jix.partition(s), tix.partition(s)
    cap = jix._capacity(jg)
    js, ts = jprep.PrepareStats(), tprep.PrepareStats()
    jprep.subtree_prepare_batch(jix._device_text(s), jg, cap,
                                jix.config.elastic_config(), js)
    tprep.subtree_prepare_batch(tix._device_text(s), tg, cap,
                                tix.config.elastic_config(), ts)
    assert (ts.iterations, ts.ranges, ts.active_history,
            ts.symbols_fetched) == (js.iterations, js.ranges,
                                    js.active_history, js.symbols_fetched)


def test_device_text_words_equal():
    s, _ = j_dataset("dna", 2000, seed=7)
    jix, tix = _both(s, "dna", 2048)
    np.testing.assert_array_equal(words_to_numpy(tix._device_text(s).words),
                                  np.asarray(jix._device_text(s).words))


def test_byte_knob_only_refused_on_dense_text(monkeypatch):
    """Once refused, now run: ``REPRO_WORD_COMPARE=byte`` changes nothing
    on byte text (JAX reads it only for a dense text), and on dense text
    it runs the byte branch on ``range_gather_packed`` keys; both equal
    JAX under the same leg, and the dense run equals the word leg."""
    monkeypatch.setenv("REPRO_WORD_COMPARE", "byte")
    s = J_ALPHABETS["protein"].random_string(800, seed=4)
    jst, tst, _ = _run(s, "protein", 2048)
    _assert_fields(jst, tst)
    s = J_ALPHABETS["dna"].random_string(300, seed=4)
    jst, tst, _ = _run(s, "dna", 2048)
    _assert_fields(jst, tst)
    monkeypatch.setenv("REPRO_WORD_COMPARE", "word")
    _, tword, _ = _run(s, "dna", 2048)
    for field in FIELDS:
        assert torch.equal(getattr(tst, field), getattr(tword, field)), field


@pytest.mark.parametrize("leg", sorted(DENSE_LEGS))
@pytest.mark.parametrize("name,alpha,n,mem", [
    ("genome", "dna", 5_000, 1 << 12),        # dense words
    ("protein", "protein", 4_000, 1 << 13),   # the byte string
])
def test_steps_with_fused_mask_equal(monkeypatch, leg, name, alpha, n, mem):
    """``prepare_step`` and ``compact_step_batch``, whose gathers now zero
    the inactive rows themselves (the row mask), against JAX's
    ``prepare_step`` (vmapped) and ``compact_step_batch`` array for array
    after every elastic iteration, with each package's knobs choosing
    the sort, the compaction and the key currency under the leg."""
    for var, val in DENSE_LEGS[leg].items():
        monkeypatch.setenv(var, val)
    s, _ = j_dataset(name, n, seed=1)
    jix, tix = _both(s, alpha, mem)
    jg, tg = jix.partition(s), tix.partition(s)
    cap = jix._capacity(jg)
    jtext, ttext = jix._device_text(s), tix._device_text(s)
    jst, tst = jprep.init_batch(jg, cap), tprep.init_batch(tg, cap, "cpu")
    sort_fuse, compact = tops._use_sort_fuse(), tops._use_compaction()
    word_keys = tops._use_word_compare()
    assert (sort_fuse, compact, word_keys) == (
        jops._use_sort_fuse(), jops._use_compaction(),
        jops._use_word_compare())
    ecfg = tix.config.elastic_config()
    n_active = np.asarray((tst.area >= 0).sum(dim=1))
    steps = {"prepare_step": 0, "compact_step_batch": 0}
    while n_active.max() > 0:
        w = tprep.elastic_range(ecfg, int(n_active.max()))
        f_prime = (tprep.compaction_width(int(n_active.max()), cap)
                   if compact else None)
        kw = dict(w=w, sort_fuse=sort_fuse, word_keys=word_keys)
        if f_prime is None:
            jst, jn = jprep.prepare_step_batch(jtext, jst, use_pallas=False,
                                               **kw)
            tst, tn = tprep.prepare_step(ttext, tst, **kw)
            steps["prepare_step"] += 1
        else:
            jst, jn = jprep.compact_step_batch(jtext, jst, f_prime=f_prime,
                                               use_pallas=False, **kw)
            tst, tn = tprep.compact_step_batch(ttext, tst, f_prime=f_prime,
                                               **kw)
            steps["compact_step_batch"] += 1
        _assert_fields(jst, tst)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        n_active = tn.numpy()
    assert steps["prepare_step"] >= 1
    assert (steps["compact_step_batch"] >= 1) == compact

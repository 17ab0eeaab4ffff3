"""PyTorch port vs the JAX package: the three kernels on the main path.

Each plain PyTorch version (the path a CPU tensor takes through the
kernel wrappers) is held against the JAX Pallas kernel in interpret mode
and against its JAX reference, on the shape sweeps of
``tests/test_packed.py::TestWordCompareKernels`` and of
``tests/test_kernels.py::TestKmerHistogram``.  Tolerance: exact — every
quantity is an integer.  ``tests/test_torch_cuda.py`` holds the hand
kernels themselves against these plain versions on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpk
from repro.core.alphabet import BYTE, DNA, PROTEIN_CLASS
from repro.kernels import ref as jref
from repro.kernels.kmer_histogram import kmer_histogram as j_kmer
from repro.kernels.packed_gather import pattern_probe_words as j_probe
from repro.kernels.packed_gather import range_gather_words as j_gather
from repro_torch.core import packing as tpk
from repro_torch.core.alphabet import ALPHABETS
from repro_torch.kernels import kmer_histogram as tkmer
from repro_torch.kernels import ops
from repro_torch.kernels import packed_gather as tpg


def _texts(alpha, n, extra, seed):
    s = alpha.random_string(n, seed=seed)
    jt = jpk.pack_text(s, alpha, extra=extra)
    tt = tpk.pack_text(s, ALPHABETS[alpha.name], extra=extra, device="cpu")
    return s, jt, tt


@pytest.mark.parametrize("alpha,n,f,w,tile", [
    (DNA, 900, 33, 16, 32), (DNA, 2000, 64, 64, 64),
    (PROTEIN_CLASS, 800, 21, 32, 64), (BYTE, 500, 16, 8, 32),
], ids=lambda v: getattr(v, "name", v))
def test_range_gather_words_equal(alpha, n, f, w, tile):
    rng = np.random.default_rng(n + f)
    s, jt, tt = _texts(alpha, n, w + 8, seed=n)
    offs = np.concatenate([rng.integers(0, n, size=f),
                           [n - 2, n - 1, n]]).astype(np.int32)
    pallas = j_gather(jt, jnp.asarray(offs), w, tile=tile, interpret=True)
    want = jref.range_gather_words_ref(jt, jnp.asarray(offs), w)
    got = tpg.range_gather_words(tt, torch.from_numpy(offs), w)
    np.testing.assert_array_equal(np.asarray(pallas), np.asarray(want))
    np.testing.assert_array_equal(tpk.words_to_numpy(got), np.asarray(want))


def test_range_gather_words_tile_straddle():
    tile = 32
    s, jt, tt = _texts(DNA, 3 * 32 * 16, 72, seed=8)
    spw = tt.syms_per_word
    offs = np.array([tile * spw - 1, tile * spw - 17, tile * spw,
                     2 * tile * spw - 3], np.int32)
    pallas = j_gather(jt, jnp.asarray(offs), 64, tile=tile, interpret=True)
    got = ops.range_gather_words(tt, torch.from_numpy(offs), 64)
    np.testing.assert_array_equal(tpk.words_to_numpy(got), np.asarray(pallas))


def _probe_inputs(alpha, n, b, m, rng):
    s = alpha.random_string(n, seed=n)
    sp = alpha.pad_string(s, extra=32)
    pos = np.concatenate([rng.integers(0, n, size=b - 5),
                          rng.integers(max(0, n - m), n + 1, 5)]
                         ).astype(np.int32)
    m_pad = -(-m // 4) * 4
    lengths = rng.integers(1, m + 1, size=len(pos)).astype(np.int32)
    sym = rng.integers(0, len(alpha.symbols),
                       size=(len(pos), m_pad)).astype(np.int32)
    for i in range(0, len(pos), 3):  # plant exact matches (verdict 0)
        j = int(rng.integers(0, n - m_pad))
        sym[i] = sp[j : j + m_pad]
        pos[i] = j
    valid = np.arange(m_pad)[None, :] < lengths[:, None]
    return s, sp, pos, lengths, np.where(valid, sym, 0), valid


@pytest.mark.parametrize("alpha,n,b,m", [
    (DNA, 400, 25, 4), (DNA, 900, 40, 16),
    (PROTEIN_CLASS, 700, 33, 8), (BYTE, 500, 16, 12),
], ids=lambda v: getattr(v, "name", v))
def test_pattern_probe_words_equal(alpha, n, b, m):
    """Plain port version == JAX Pallas (interpret) == JAX word ref ==
    the JAX byte-probe oracle, terminal tail positions included."""
    rng = np.random.default_rng(n + b)
    s, sp, pos, lengths, sym, valid = _probe_inputs(alpha, n, b, m, rng)
    jt = jpk.pack_text(s, alpha, extra=32)
    tt = tpk.pack_text(s, ALPHABETS[alpha.name], extra=32, device="cpu")
    bits = jt.bits
    pat_b = jref.pack_words_ref(jnp.asarray(sym))
    mask_b = jref.pack_words_ref(jnp.asarray(np.where(valid, 0xFF, 0)))
    oracle = np.asarray(jref.pattern_probe_ref(jnp.asarray(sp),
                                               jnp.asarray(pos), pat_b, mask_b))
    pat_d = jpk.pack_pattern_dense(jnp.asarray(sym), bits, jt.terminal)
    mask_d = jpk.pack_dense(jnp.asarray(np.where(valid, (1 << bits) - 1, 0)),
                            bits)
    pallas = j_probe(jt, jnp.asarray(pos), pat_d, mask_d, jnp.asarray(lengths),
                     tile=64, interpret=True)
    jwant = jref.pattern_probe_words_ref(jt, jnp.asarray(pos), pat_d, mask_d,
                                         jnp.asarray(lengths))
    tpat = tpk.pack_pattern_dense(torch.from_numpy(sym), bits, tt.terminal)
    tmask = tpk.pack_dense(torch.from_numpy(
        np.where(valid, (1 << bits) - 1, 0).astype(np.int32)), bits)
    got = tpg.pattern_probe_words(tt, torch.from_numpy(pos), tpat, tmask,
                                  torch.from_numpy(lengths))
    np.testing.assert_array_equal(np.asarray(pallas), oracle)
    np.testing.assert_array_equal(np.asarray(jwant), oracle)
    np.testing.assert_array_equal(got.numpy(), oracle)


def test_pattern_probe_words_lim_p_equal():
    """A terminal-padded pattern side (explicit lim_p) follows the same
    limit rules in both packages."""
    rng = np.random.default_rng(21)
    s, sp, pos, lengths, sym, valid = _probe_inputs(DNA, 600, 30, 16, rng)
    jt = jpk.pack_text(s, DNA, extra=32)
    tt = tpk.pack_text(s, ALPHABETS["dna"], extra=32, device="cpu")
    lim_p = np.minimum(lengths, rng.integers(0, 17, size=len(pos))).astype(np.int32)
    pat_d = jpk.pack_pattern_dense(jnp.asarray(sym), 2, jt.terminal)
    mask_d = jpk.pack_dense(jnp.asarray(np.where(valid, 3, 0)), 2)
    want = jref.pattern_probe_words_ref(jt, jnp.asarray(pos), pat_d, mask_d,
                                        jnp.asarray(lengths), jnp.asarray(lim_p))
    got = ops.pattern_probe_words(
        tt, torch.from_numpy(pos), torch.from_numpy(np.array(pat_d).view(np.int32)),
        torch.from_numpy(np.array(mask_d).view(np.int32)),
        torch.from_numpy(lengths), torch.from_numpy(lim_p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,k,base,tile", [
    (100, 1, 5, 32), (1000, 2, 5, 64), (4000, 3, 5, 128),
    (900, 2, 21, 64), (333, 1, 27, 32), (2048, 4, 5, 256),
])
def test_kmer_histogram_equal(n, k, base, tile):
    rng = np.random.default_rng(n * k)
    s = rng.integers(0, base - 1, size=n).astype(np.uint8)
    s[-1] = base - 1
    sp = np.concatenate([s, np.full(k + 2, base - 1, np.uint8)])
    pallas = j_kmer(jnp.asarray(sp), n, k, base, tile=tile, interpret=True)
    want = jref.kmer_histogram_ref(jnp.asarray(sp), n, k, base)
    got = tkmer.kmer_histogram(torch.from_numpy(sp), n, k, base)
    np.testing.assert_array_equal(np.asarray(pallas), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32 and int(got.sum()) == n


def test_kmer_histogram_contract():
    s = torch.zeros(10, dtype=torch.uint8)
    with pytest.raises(ValueError, match="bins"):
        ops.kmer_histogram(s, 4, 7, 5)  # 5**7 > 2**16
    with pytest.raises(ValueError, match="reads"):
        ops.kmer_histogram(s, 10, 3, 5)  # needs n + k - 1 symbols


def test_cpu_tensors_take_plain_versions_uncounted():
    ops.reset_launch_counts()
    s, jt, tt = _texts(DNA, 300, 24, seed=2)
    offs = torch.arange(0, 300, 7, dtype=torch.int32)
    ops.range_gather_words(tt, offs, 16)
    ops.kmer_histogram(torch.zeros(20, dtype=torch.uint8), 10, 2, 5)
    assert ops.launch_counts() == {"range_gather_words": 0,
                                   "pattern_probe_words": 0,
                                   "kmer_histogram": 0}


def test_other_devices_raise():
    s, jt, tt = _texts(DNA, 100, 24, seed=4)
    meta = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.range_gather_words(tt, meta, 16)


def test_resolve_device_refuses_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.resolve_device("cuda")
    assert ops.resolve_device("cpu").type == "cpu"


def test_knobs(monkeypatch):
    for var in ("REPRO_WORD_COMPARE", "REPRO_SORT", "REPRO_COMPACT"):
        monkeypatch.delenv(var, raising=False)
    assert ops._use_word_compare() and ops._use_sort_fuse()
    assert ops._use_compaction()
    monkeypatch.setenv("REPRO_WORD_COMPARE", "byte")
    with pytest.raises(NotImplementedError, match="A7"):
        ops._use_word_compare()
    monkeypatch.setenv("REPRO_WORD_COMPARE", "bogus")
    with pytest.raises(ValueError, match="REPRO_WORD_COMPARE"):
        ops._use_word_compare()
    monkeypatch.setenv("REPRO_SORT", "lexsort")
    monkeypatch.setenv("REPRO_COMPACT", "off")
    assert not ops._use_sort_fuse() and not ops._use_compaction()
    monkeypatch.setenv("REPRO_SORT", "bogus")
    with pytest.raises(ValueError, match="REPRO_SORT"):
        ops._use_sort_fuse()


def test_missing_nvcc_raises(monkeypatch):
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()

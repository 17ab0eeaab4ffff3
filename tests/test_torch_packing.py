"""PyTorch port vs the JAX package: the dense word currency (core/packing).

Inputs come from a seed with numpy and go to both packages; the port runs
on the CPU.  Tolerance: exact — every quantity is an integer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpk
from repro.core.alphabet import BYTE as J_BYTE
from repro.core.alphabet import DNA as J_DNA
from repro.core.alphabet import PROTEIN as J_PROTEIN
from repro.core.alphabet import PROTEIN_CLASS as J_PC
from repro_torch.core import packing as tpk
from repro_torch.core.alphabet import ALPHABETS
from repro_torch.kernels import pack_text as tpack
from repro_torch.kernels import ref as tref

ALPHAS = [J_DNA, J_PC, J_BYTE]
IDS = [a.name for a in ALPHAS]


def _pair(j_alpha, n, seed, extra):
    s = j_alpha.random_string(n, seed=seed)
    jt = jpk.pack_text(s, j_alpha, extra=extra)
    tt = tpk.pack_text(s, ALPHABETS[j_alpha.name], extra=extra, device="cpu")
    return s, jt, tt


def _offsets(rng, n, w, spw, count):
    """Random offsets plus every offset within w of n_real and a run across
    a word boundary."""
    near_end = np.arange(max(0, n - w), n + 1)
    boundary = np.arange(spw * 3 - 2, spw * 3 + 3)
    return np.concatenate([rng.integers(0, n + 1, size=count), near_end,
                           boundary[boundary <= n]]).astype(np.int32)


@pytest.mark.parametrize("alpha", ALPHAS, ids=IDS)
@pytest.mark.parametrize("n", [1, 37, 1000])
def test_pack_text_words_equal(alpha, n):
    s, jt, tt = _pair(alpha, n, seed=n, extra=24)
    np.testing.assert_array_equal(tt.words_numpy(), np.asarray(jt.words))
    assert tt.n_real == int(jt.n_real) and tt.bits == jt.bits
    assert tt.terminal == jt.terminal
    np.testing.assert_array_equal(tpk.unpack_text(tt), s)


def test_pack_text_rejects_unterminated():
    with pytest.raises(ValueError, match="terminated"):
        tpk.pack_text(np.zeros(4, np.uint8), ALPHABETS["dna"], device="cpu")


# every dense width: 2-bit DNA, 4-bit protein classes, 8-bit protein (the
# alphabet under packing="dense") and bytes
DENSE = [J_DNA, J_PC, J_PROTEIN, J_BYTE]


@pytest.mark.parametrize("alpha", DENSE, ids=[a.name for a in DENSE])
@pytest.mark.parametrize("words, delta", [(0, 0), (0, 1), (1, -1), (1, 0),
                                          (1, 1), (7, -1), (7, 0), (7, 1)])
@pytest.mark.parametrize("extra", [0, 8, 264])
def test_pack_text_dense_plain_equals_jax(alpha, words, delta, extra):
    """The plain version of the ``pack_text_dense`` kernel, its wrapper on
    the CPU and ``pack_text`` give the JAX words bit for bit, at lengths
    at, below and above a multiple of the symbols a word, with 0 and 1
    real symbols, under several read tails."""
    spw = 32 // alpha.dense_bits
    n = max(words * spw + delta, 0)
    s = alpha.random_string(n, seed=1000 * words + 10 * delta + extra + 5)
    want = np.asarray(jpk.pack_text(s, alpha, extra=extra).words)
    codes = torch.from_numpy(s[:-1].copy())
    bits = alpha.dense_bits
    plain = tref.pack_text_dense_ref(codes, want.size, bits)
    wrapped = tpack.pack_text_dense(codes, want.size, bits, alpha.name)
    packed = tpk.pack_text(s, ALPHABETS[alpha.name], extra=extra,
                           device="cpu")
    for got in (plain, wrapped, packed.words):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(tpk.words_to_numpy(got), want)
    assert packed.n_real == n and packed.bits == bits


def _bad_string(alpha, case):
    s = alpha.random_string(40, seed=7)
    if case == "out_of_range":
        s[17] = 1 << alpha.dense_bits
    elif case == "unterminated":
        s = s[:-1]
    else:  # empty
        s = s[:0]
    return s


@pytest.mark.parametrize("alpha", [J_DNA, J_PC], ids=["dna", "protein_class"])
@pytest.mark.parametrize("case", ["out_of_range", "unterminated", "empty"])
def test_pack_text_rejects_as_jax(alpha, case):
    """A code past the dense width, a string without its terminal and an
    empty one raise the JAX package's ``ValueError``, message and all."""
    s = _bad_string(alpha, case)
    with pytest.raises(ValueError) as want:
        jpk.pack_text(s, alpha, extra=8)
    with pytest.raises(ValueError) as got:
        tpk.pack_text(s, ALPHABETS[alpha.name], extra=8, device="cpu")
    assert str(got.value) == str(want.value)
    if case == "out_of_range":
        with pytest.raises(ValueError) as wrapped:
            tpack.pack_text_dense(torch.from_numpy(s[:-1].copy()), 16,
                                  alpha.dense_bits, alpha.name)
        assert str(wrapped.value) == str(want.value)


@pytest.mark.parametrize("args, match", [
    ((torch.zeros(4, dtype=torch.uint8), 2, 3), "bits"),
    ((torch.zeros(33, dtype=torch.uint8), 2, 2), "cannot hold"),
    ((torch.zeros(4, dtype=torch.int32), 2, 2), "uint8"),
])
def test_pack_text_dense_rejects_arguments(args, match):
    with pytest.raises(ValueError, match=match):
        tpack.pack_text_dense(*args)


def test_from_numpy_round_trips_jax_words():
    s, jt, _ = _pair(J_DNA, 500, seed=3, extra=16)
    pt = tpk.PackedText.from_numpy(np.asarray(jt.words), int(jt.n_real),
                                   jt.bits, jt.terminal, device="cpu")
    assert pt.words.dtype == torch.int32
    np.testing.assert_array_equal(pt.words_numpy(), np.asarray(jt.words))


@pytest.mark.parametrize("alpha", ALPHAS, ids=IDS)
@pytest.mark.parametrize("w", [4, 16, 64, 256])
def test_gather_words_dense_equal(alpha, w):
    n = 700
    rng = np.random.default_rng(w)
    s, jt, tt = _pair(alpha, n, seed=w + 1, extra=w + 8)
    offs = _offsets(rng, n, w, tt.syms_per_word, 60)
    want = np.asarray(jpk.gather_words_dense(jt, jnp.asarray(offs), w))
    got = tpk.gather_words_dense(tt, torch.from_numpy(offs), w)
    np.testing.assert_array_equal(tpk.words_to_numpy(got), want)


@pytest.mark.parametrize("alpha", ALPHAS, ids=IDS)
def test_word_sort_keys_equal(alpha):
    n, w = 400, 32
    rng = np.random.default_rng(5)
    s, jt, tt = _pair(alpha, n, seed=9, extra=w + 8)
    offs = _offsets(rng, n, w, tt.syms_per_word, 40)
    jk, jtie = jpk.word_sort_keys(jt, jnp.asarray(offs), w)
    tk, ttie = tpk.word_sort_keys(tt, torch.from_numpy(offs), w)
    np.testing.assert_array_equal(tpk.words_to_numpy(tk), np.asarray(jk))
    np.testing.assert_array_equal(ttie.numpy(), np.asarray(jtie))
    assert ttie.dtype == torch.int32


@pytest.mark.parametrize("alpha", ALPHAS, ids=IDS)
@pytest.mark.parametrize("w", [4, 16, 64])
def test_lcp_adjacent_words_equal(alpha, w):
    """Adjacent rows of sorted-looking reads, limits from real offsets."""
    n = 600
    rng = np.random.default_rng(w + 3)
    s, jt, tt = _pair(alpha, n, seed=w, extra=w + 8)
    offs = _offsets(rng, n, w, tt.syms_per_word, 50)
    # repeat offsets so some adjacent rows are fully equal
    offs = np.sort(np.concatenate([offs, offs[:10]])).astype(np.int32)
    jrows = jpk.gather_words_dense(jt, jnp.asarray(offs), w)
    jlim = jpk.word_limit(jt.n_real, jnp.asarray(offs), w)
    want = jpk.lcp_adjacent_words(jrows[:-1], jrows[1:], jlim[:-1], jlim[1:],
                                  w, jt.bits, jt.terminal)
    trows = tpk.gather_words_dense(tt, torch.from_numpy(offs), w)
    tlim = tpk.word_limit(tt.n_real, torch.from_numpy(offs), w)
    got = tpk.lcp_adjacent_words(trows[:-1], trows[1:], tlim[:-1], tlim[1:],
                                 w, tt.bits, tt.terminal)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_pack_dense_and_pattern_equal(bits):
    rng = np.random.default_rng(bits)
    terminal = {2: 4, 4: 10, 8: 255}[bits]
    sym = rng.integers(0, terminal + 1, size=(9, 37)).astype(np.int32)
    np.testing.assert_array_equal(
        tpk.words_to_numpy(tpk.pack_pattern_dense(torch.from_numpy(sym), bits,
                                                  terminal)),
        np.asarray(jpk.pack_pattern_dense(jnp.asarray(sym), bits, terminal)))
    real = np.minimum(sym, (1 << bits) - 1)
    np.testing.assert_array_equal(
        tpk.words_to_numpy(tpk.pack_dense(torch.from_numpy(real), bits)),
        np.asarray(jpk.pack_dense(jnp.asarray(real), bits)))


def test_clz32_equal():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        [0, 1, 2, 3, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0x00010000, 0xFFFF],
        rng.integers(0, 1 << 32, size=200, dtype=np.uint64),
        1 << rng.integers(0, 32, size=50, dtype=np.uint64),
    ]).astype(np.uint32)
    want = np.asarray(jpk.clz32(jnp.asarray(x)))
    got = tpk.clz32(torch.from_numpy(x.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_int32_bit_pattern_helpers_round_trip():
    x = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
    as_i32 = torch.from_numpy(x.view(np.int32))
    u = tpk.to_u64(as_i32)
    np.testing.assert_array_equal(u.numpy(), x.astype(np.int64))
    np.testing.assert_array_equal(tpk.words_to_numpy(tpk.to_i32(u)), x)


@pytest.mark.parametrize("mode,expect", [("auto", [True, True, False, False]),
                                         ("dense", [True] * 4),
                                         ("bytes", [False] * 4)])
def test_resolve_dense_equal(mode, expect):
    names = ["dna", "protein_class", "protein", "byte"]
    got = [tpk.resolve_dense(mode, ALPHABETS[a]) for a in names]
    from repro.core.alphabet import ALPHABETS as J
    want = [jpk.resolve_dense(mode, J[a]) for a in names]
    assert got == want == expect


# ---- byte keys (the byte-key currency) -------------------------------------

BYTE_ALPHAS = [J_DNA, J_PC, J_BYTE]


def test_pack_words_equal_with_high_codes():
    """Codes >= 128 set bit 31 of the key: packed in int64, wrapped to the
    int32 bit pattern JAX's wrapping int32 multiply gives (hazard C5)."""
    rng = np.random.default_rng(1)
    sym = rng.integers(0, 256, size=(17, 24)).astype(np.int32)
    sym[0, :4] = [255, 255, 255, 255]
    sym[1, :4] = [128, 0, 0, 0]
    want = np.asarray(jpk.pack_words(jnp.asarray(sym)))
    got = tpk.pack_words(torch.from_numpy(sym))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0] == -1 and got[1, 0] == -(1 << 31)
    with pytest.raises(ValueError, match="multiple of 4"):
        tpk.pack_words(torch.zeros((2, 6), dtype=torch.int32))


@pytest.mark.parametrize("alpha", BYTE_ALPHAS, ids=[a.name for a in BYTE_ALPHAS])
@pytest.mark.parametrize("w", [4, 16, 64, 256])
def test_gather_pack_equal(alpha, w):
    """Byte keys from the terminal-padded string, offsets up to and past
    the padding (the clamp to the last index)."""
    n = 600
    rng = np.random.default_rng(w + 7)
    s = alpha.random_string(n, seed=w)
    sp = alpha.pad_string(s, extra=w // 2)
    offs = np.concatenate([rng.integers(0, n + 1, size=50),
                           np.arange(n - 4, len(sp))]).astype(np.int32)
    want = np.asarray(jpk.gather_pack(jnp.asarray(sp), jnp.asarray(offs), w))
    got = tpk.gather_pack(torch.from_numpy(sp), torch.from_numpy(offs), w)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("alpha", BYTE_ALPHAS, ids=[a.name for a in BYTE_ALPHAS])
@pytest.mark.parametrize("w", [4, 16, 64])
def test_gather_pack_dense_equal(alpha, w):
    """Byte keys repacked from dense words == JAX == the byte gather
    (tests/test_packed.py::TestGatherPackDense)."""
    rng = np.random.default_rng(w)
    n = 900
    s, jt, tt = _pair(alpha, n, seed=9, extra=w + 8)
    sp = alpha.pad_string(s, extra=w + 8)
    offs = np.concatenate([rng.integers(0, len(s), size=65),
                           [len(s) - 2, len(s) - 1, len(s), len(s) + 3]]
                          ).astype(np.int32)
    want = np.asarray(jpk.gather_pack_dense(jt, jnp.asarray(offs), w))
    got = tpk.gather_pack_dense(tt, torch.from_numpy(offs), w)
    np.testing.assert_array_equal(got.numpy(), want)
    byte = tpk.gather_pack(torch.from_numpy(sp), torch.from_numpy(offs), w)
    np.testing.assert_array_equal(got.numpy(), byte.numpy())


@pytest.mark.parametrize("alpha", ALPHAS, ids=IDS)
def test_gather_symbols_dense_equal(alpha):
    n, w = 500, 21
    rng = np.random.default_rng(4)
    s, jt, tt = _pair(alpha, n, seed=4, extra=w + 8)
    offs = _offsets(rng, n, w, tt.syms_per_word, 30)
    want = np.asarray(jpk.gather_symbols_dense(jt, jnp.asarray(offs), w))
    got = tpk.gather_symbols_dense(tt, torch.from_numpy(offs), w)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_flip_sign_orders_unsigned():
    x = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0xDEADBEEF],
                 np.uint32)
    flipped = tpk.flip_sign(torch.from_numpy(x.view(np.int32)))
    want = np.asarray(jpk.flip_sign(jnp.asarray(x.view(np.int32))))
    np.testing.assert_array_equal(flipped.numpy(), want)
    assert np.array_equal(np.argsort(flipped.numpy(), kind="stable"),
                          np.argsort(x, kind="stable"))

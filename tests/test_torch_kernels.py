"""PyTorch port vs the JAX package: the kernels on the ported paths.

Each plain PyTorch version (the path a CPU tensor takes through the
kernel wrappers) is held against the JAX Pallas kernel in interpret mode
and against its JAX reference, on the shape sweeps of
``tests/test_packed.py::TestWordCompareKernels`` /
``::TestPackedKernels`` and of ``tests/test_kernels.py::TestKmerHistogram``
/ ``::TestRangeGatherPack`` / ``::TestLcpPairs`` / ``::TestPatternProbe``
/ ``::TestSuffixLcp`` (pairs within ``w`` of the end included).
Tolerance: exact — every quantity is an integer.
``tests/test_torch_cuda.py`` holds the hand kernels themselves against
these plain versions on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpk
from repro.core.alphabet import BYTE, DNA, PROTEIN_CLASS
from repro.kernels import ref as jref
from repro.kernels.kmer_histogram import kmer_histogram as j_kmer
from repro.kernels.lcp import lcp_pairs as j_lcp
from repro.kernels.packed_gather import pattern_probe_packed as j_probe_packed
from repro.kernels.packed_gather import pattern_probe_words as j_probe
from repro.kernels.packed_gather import range_gather_words as j_gather
from repro.kernels.pattern_probe import pattern_probe as j_probe_bytes
from repro.kernels.range_gather import range_gather_pack as j_gather_pack
from repro.kernels import ops as jops
from repro.kernels.packed_gather import range_gather_packed as j_gather_packed
from repro.kernels.packed_gather import suffix_lcp_words as j_lcp_words
from repro.kernels.suffix_lcp import suffix_lcp_pairs as j_suffix_lcp
from repro.kernels.probe_gather import probe_gather_packed as j_fused_packed
from repro.kernels.probe_gather import probe_gather_words as j_fused_words
from repro.kernels.flash_attention import flash_attention as j_flash
from repro_torch.core import packing as tpk
from repro_torch.core.alphabet import ALPHABETS
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import kmer_histogram as tkmer
from repro_torch.kernels import lcp as tlcp
from repro_torch.kernels import ops
from repro_torch.kernels import packed_gather as tpg
from repro_torch.kernels import pattern_probe as tprobe
from repro_torch.kernels import probe_gather as tfused
from repro_torch.kernels import range_gather as trg
from repro_torch.kernels import ref as tref
from repro_torch.kernels import search as tsearch
from repro_torch.kernels import suffix_lcp as tslcp


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


MASK_KINDS = ("all", "none", "mixed")


def _row_mask(kind, f, rng):
    if kind == "all":
        return np.ones(f, bool)
    if kind == "none":
        return np.zeros(f, bool)
    return rng.random(f) < 0.5


@pytest.mark.parametrize("mask_kind", MASK_KINDS)
@pytest.mark.parametrize("alpha,n,f,w", [
    (DNA, 900, 41, 16), (DNA, 700, 1, 64), (DNA, 300, 0, 16),
    (PROTEIN_CLASS, 800, 37, 32), (BYTE, 500, 29, 8), (BYTE, 400, 1, 256),
], ids=lambda v: getattr(v, "name", v))
def test_range_gather_words_masked_equal(alpha, n, f, w, mask_kind):
    """The masked plain version == JAX's ``jnp.where(active, gather, 0)``
    of the elastic step, the gather as Pallas (interpret) and as its jnp
    reference; offsets at and just before ``n_real``."""
    rng = np.random.default_rng(n + f + w)
    s, jt, tt = _texts(alpha, n, w + 8, seed=n)
    offs = rng.integers(0, n + 1, size=f).astype(np.int32)
    offs[-2:] = [n - 1, n][-min(f, 2):] if f else []
    mask = _row_mask(mask_kind, f, rng)
    jm = jnp.asarray(mask)[:, None]
    want = np.asarray(jnp.where(jm, jref.range_gather_words_ref(
        jt, jnp.asarray(offs), w), jnp.uint32(0)))
    if f:
        pallas = j_gather(jt, jnp.asarray(offs), w, tile=128, interpret=True)
        np.testing.assert_array_equal(
            np.asarray(jnp.where(jm, pallas, jnp.uint32(0))), want)
    got = tpg.range_gather_words(tt, torch.from_numpy(offs), w,
                                 mask=torch.from_numpy(mask))
    assert got.shape == (f, -(-w // tt.syms_per_word))
    np.testing.assert_array_equal(tpk.words_to_numpy(got), want)


@pytest.mark.parametrize("mask_kind", MASK_KINDS)
@pytest.mark.parametrize("name,n,f,w", [
    ("protein", 500, 37, 16), ("protein", 300, 1, 4), ("protein", 600, 45, 256),
    ("byte", 400, 29, 32), ("byte", 200, 0, 8),
])
def test_range_gather_pack_masked_equal(name, n, f, w, mask_kind):
    """The masked plain version == JAX's ``jnp.where(active, gather, 0)``
    on the terminal-padded string (Pallas interpret and the jnp
    reference); offsets at ``n_real`` and at the end of the padding."""
    rng = np.random.default_rng(n + f + w)
    a = ALPHABETS[name]
    sp = a.pad_string(a.random_string(n, seed=n), extra=w + 8)
    offs = rng.integers(0, n + 1, size=f).astype(np.int32)
    edges = [n - 1, n, sp.size - 5, sp.size - 1]
    offs[-min(f, 4):] = edges[-min(f, 4):] if f else []
    mask = _row_mask(mask_kind, f, rng)
    jm = jnp.asarray(mask)[:, None]
    want = np.asarray(jnp.where(jm, jref.range_gather_pack_ref(
        jnp.asarray(sp), jnp.asarray(offs), w), 0))
    if f:
        pallas = j_gather_pack(jnp.asarray(sp), jnp.asarray(offs), w,
                               tile=512, interpret=True)
        np.testing.assert_array_equal(np.asarray(jnp.where(jm, pallas, 0)),
                                      want)
    got = trg.range_gather_pack(torch.from_numpy(sp), torch.from_numpy(offs),
                                w, mask=torch.from_numpy(mask))
    assert got.shape == (f, w // 4) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # through the dispatcher, and on the dense text of a dense alphabet
    assert ops.range_gather(torch.from_numpy(sp), torch.from_numpy(offs), w,
                            mask=torch.from_numpy(mask)).equal(got)


@pytest.mark.parametrize("mask_kind", MASK_KINDS)
def test_range_gather_dispatch_masked_dense(mask_kind):
    """``ops.range_gather`` with a mask on a dense text (the byte-key
    oracle's read) equals the masked byte-string gather."""
    rng = np.random.default_rng(5)
    s, jt, tt = _texts(DNA, 600, 72, seed=6)
    sp = DNA.pad_string(s, extra=72)
    offs = np.append(rng.integers(0, 600, size=30), [599, 600]).astype(np.int32)
    mask = torch.from_numpy(_row_mask(mask_kind, offs.size, rng))
    got = ops.range_gather(tt, torch.from_numpy(offs), 16, mask=mask)
    want = ops.range_gather(torch.from_numpy(sp), torch.from_numpy(offs), 16,
                            mask=mask)
    assert got.equal(want)


@pytest.mark.parametrize("mask_kind", MASK_KINDS)
@pytest.mark.parametrize("alpha,n,f,w", [
    (DNA, 700, 41, 4), (DNA, 500, 1, 64), (PROTEIN_CLASS, 600, 37, 16),
    (BYTE, 400, 29, 256), (DNA, 300, 0, 8),
], ids=lambda v: getattr(v, "name", v))
def test_range_gather_packed_masked_equal(alpha, n, f, w, mask_kind):
    """``ops.range_gather`` on a dense text with the elastic step's mask
    (the mask passed into ``range_gather_packed``, no ``torch.where``
    after it) == JAX's ``range_gather_packed_ref`` with the masked rows
    zeroed; offsets at and past ``n_real``."""
    rng = np.random.default_rng(n + f + w)
    s, jt, tt = _texts(alpha, n, w + 8, seed=n)
    offs = rng.integers(0, n + 1, size=f).astype(np.int32)
    offs[-3:] = [n - 1, n, n + 3][-min(f, 3):] if f else []
    mask = _row_mask(mask_kind, f, rng)
    want = np.asarray(jnp.where(jnp.asarray(mask)[:, None],
                                jref.range_gather_packed_ref(
                                    jt, jnp.asarray(offs), w), 0))
    got = ops.range_gather(tt, torch.from_numpy(offs), w,
                           mask=torch.from_numpy(mask))
    assert got.shape == (f, w // 4) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert tpg.range_gather_packed(tt, torch.from_numpy(offs), w,
                                   mask=torch.from_numpy(mask)).equal(got)


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


_KMER_CASES = [
    (100, 1, 5, 32, "random"), (1000, 2, 5, 64, "random"),
    (4000, 3, 5, 128, "random"), (900, 2, 21, 64, "random"),
    (333, 1, 27, 32, "random"), (2048, 4, 5, 256, "random"),
    # 2^16 bins (the card's cluster layout) and PROTEIN_CLASS k = 4
    (700, 2, 256, 64, "random"), (1500, 4, 11, 128, "random"),
    # one window; n not a multiple of 16 or 32
    (1, 3, 5, 32, "random"), (1001, 3, 5, 64, "random"),
    (77, 2, 21, 32, "random"),
    # a view that starts inside a larger array (the card's unaligned
    # head), and a homopolymer (one bin holds n)
    (999, 3, 5, 64, "offset"), (517, 2, 256, 64, "offset"),
    (1000, 6, 5, 128, "homopolymer"), (600, 2, 256, 64, "homopolymer"),
]


def _kmer_string(n, k, base, data):
    """``n + k + 2`` symbols ``< base`` (the last ``k + 2`` the padding) and
    the start of the windows in them."""
    rng = np.random.default_rng(n * k)
    if data == "homopolymer":
        return np.full(n + k + 2, base // 2, np.uint8), 0
    s = rng.integers(0, base - 1, size=n).astype(np.uint8)
    s[-1] = base - 1
    sp = np.concatenate([s, np.full(k + 2, base - 1, np.uint8)])
    if data == "offset":
        start = 13
        return np.concatenate([rng.integers(0, base, start).astype(np.uint8),
                               sp]), start
    return sp, 0


@pytest.mark.parametrize("n,k,base,tile,data", [
    pytest.param(*c, id="-".join(map(str, c[:4] if c[4] == "random" else c)))
    for c in _KMER_CASES])
def test_kmer_histogram_equal(n, k, base, tile, data):
    """Plain port version == JAX Pallas (interpret) == JAX ref."""
    full, start = _kmer_string(n, k, base, data)
    sp = full[start:]
    pallas = j_kmer(jnp.asarray(sp), n, k, base, tile=tile, interpret=True)
    want = jref.kmer_histogram_ref(jnp.asarray(sp), n, k, base)
    got = tkmer.kmer_histogram(torch.from_numpy(full)[start:], n, k, base)
    np.testing.assert_array_equal(np.asarray(pallas), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32 and int(got.sum()) == n
    if data == "homopolymer":
        assert int(got.max()) == n


@pytest.mark.parametrize("smem_optin", [tkmer.H100_SMEM_OPTIN, 101_376])
def test_kmer_histogram_plan(smem_optin):
    """Every bin count up to 2^16 gets a shared-memory layout within the
    opt-in limit: a copy per warp, one per block, or a cluster of 2 or 4
    blocks whose shares cover the bins; more bins raise."""
    counts = {base**k for base in range(2, 257) for k in range(1, 17)
              if base**k <= tkmer.MAX_BINS}
    paths = set()
    for nbins in sorted(counts | {2, 3, 511, 512, 513, 58_112, 58_113,
                                  tkmer.MAX_BINS}):
        p = tkmer.plan(nbins, smem_optin)
        paths.add(p.path)
        assert p.path in tkmer.PATHS
        assert 0 < p.smem <= smem_optin
        assert (p.cluster == 1) == (p.path != "cluster")
        assert p.cluster in (1, 2, 4)
        if p.path == "warp_copies":
            assert p.smem == tkmer.THREADS // 32 * nbins * 4
        elif p.path == "block":
            assert p.smem == nbins * 4
        else:
            assert p.smem == 4 << p.share_log2
            assert p.cluster << p.share_log2 >= nbins
            assert 4 << p.share_log2 < 2 * -(-nbins // p.cluster) * 4
    assert paths == set(tkmer.PATHS)
    assert tkmer.plan(256).path == "warp_copies"
    assert tkmer.plan(5**6).path == "block"
    assert tkmer.plan(256**2) == tkmer.Plan("cluster", 131072, 2, 15)
    for nbins in (1, tkmer.MAX_BINS + 1, 5**7):
        with pytest.raises(ValueError, match="bins"):
            tkmer.plan(nbins, smem_optin)


def test_kmer_histogram_contract():
    s = torch.zeros(10, dtype=torch.uint8)
    with pytest.raises(ValueError, match="bins"):
        ops.kmer_histogram(s, 4, 7, 5)  # 5**7 > 2**16
    with pytest.raises(ValueError, match="reads"):
        ops.kmer_histogram(s, 10, 3, 5)  # needs n + k - 1 symbols


def _byte_words(sym, valid):
    """(pattern, 0xFF mask) byte-key rows, as the JAX tests pack them."""
    return (np.array(jref.pack_words_ref(jnp.asarray(np.where(valid, sym, 0)))),
            np.array(jref.pack_words_ref(jnp.asarray(np.where(valid, 0xFF, 0)))))


@pytest.mark.parametrize("n,f,w,tile", [
    (100, 7, 4, 32), (1000, 33, 16, 64), (5000, 128, 64, 256),
    (300, 5, 32, 32), (257, 64, 8, 128), (4096, 256, 128, 512),
])
def test_range_gather_pack_equal(n, f, w, tile):
    rng = np.random.default_rng(n + f)
    s = rng.integers(0, 5, size=n).astype(np.uint8)
    s[-1] = 4
    offs = rng.integers(0, n, size=f).astype(np.int32)
    pallas = j_gather_pack(jnp.asarray(s), jnp.asarray(offs), w, tile=tile,
                           interpret=True)
    want = jref.range_gather_pack_ref(jnp.asarray(s), jnp.asarray(offs), w)
    got = trg.range_gather_pack(torch.from_numpy(s), torch.from_numpy(offs), w)
    np.testing.assert_array_equal(np.asarray(pallas), np.asarray(want))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
def test_range_gather_pack_dtypes(dtype):
    rng = np.random.default_rng(0)
    s = rng.integers(0, 21, size=500).astype(dtype)
    s[-1] = 20
    offs = rng.integers(0, 480, size=17).astype(np.int32)
    pallas = j_gather_pack(jnp.asarray(s), jnp.asarray(offs), 16, tile=64,
                           interpret=True)
    got = ops.range_gather_pack(torch.from_numpy(s), torch.from_numpy(offs), 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


def test_range_gather_pack_tile_straddle_and_byte_codes():
    """Reads across the Pallas tile boundary, and byte codes >= 128 (the
    top byte reaches bit 31: hazard C5), clamped past the end."""
    tile = 32
    s = (np.arange(128) * 37 % 256).astype(np.uint8)
    offs = np.array([tile - 1, tile - 3, 2 * tile - 2, 120, 127], np.int32)
    pallas = j_gather_pack(jnp.asarray(s), jnp.asarray(offs), 8, tile=tile,
                           interpret=True)
    want = jref.range_gather_pack_ref(jnp.asarray(s), jnp.asarray(offs), 8)
    got = ops.range_gather_pack(torch.from_numpy(s), torch.from_numpy(offs), 8)
    np.testing.assert_array_equal(np.asarray(pallas), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() < 0).any()


@pytest.mark.parametrize("f,w,blk", [(7, 4, 32), (50, 16, 32), (333, 32, 64),
                                     (128, 64, 128)])
def test_lcp_pairs_equal(f, w, blk):
    rng = np.random.default_rng(f * w)
    a = rng.integers(0, 2**25, size=(f, w // 4)).astype(np.int32)
    b = np.where(rng.random((f, w // 4)) < 0.5,
                 rng.integers(0, 2**25, size=(f, w // 4)).astype(np.int32), a)
    pallas = j_lcp(jnp.asarray(a), jnp.asarray(b), w, blk=blk, interpret=True)
    want = jref.lcp_pairs_ref(jnp.asarray(a), jnp.asarray(b), w)
    got = tlcp.lcp_pairs(torch.from_numpy(a), torch.from_numpy(b), w)
    for p, x, g in zip(pallas, want, got):
        np.testing.assert_array_equal(np.asarray(p), np.asarray(x))
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))


def test_lcp_pairs_identical_rows_and_high_bytes():
    a = np.full((9, 4), 12345, np.int32)
    lcp, c1, c2 = ops.lcp_pairs(torch.from_numpy(a), torch.from_numpy(a), 16)
    assert (lcp.numpy() == 16).all()
    assert (c1.numpy() == 0).all() and (c2.numpy() == 0).all()
    # rows differing in a byte >= 128, and a window wider than w
    rng = np.random.default_rng(5)
    x = rng.integers(0, 2**32, size=(40, 3), dtype=np.uint64).astype(np.uint32)
    y = x.copy()
    y[::2, 1] ^= np.uint32(0x80000000)
    y[1::4, 2] ^= np.uint32(0x00F00000)
    x, y = x.view(np.int32), y.view(np.int32)
    want = jref.lcp_pairs_ref(jnp.asarray(x), jnp.asarray(y), 10)
    got = ops.lcp_pairs(torch.from_numpy(x), torch.from_numpy(y), 10)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert (got[1].numpy() >= 128).any()


@pytest.mark.parametrize("n,b,m,tile,codes", [
    (300, 7, 4, 32, 5), (1000, 33, 8, 64, 21), (2000, 64, 16, 256, 27),
    (500, 16, 12, 128, 256),  # byte alphabet: top bit of packed words set
])
def test_pattern_probe_equal(n, b, m, tile, codes):
    rng = np.random.default_rng(n + b)
    s = rng.integers(0, codes, size=n).astype(np.uint8)
    s[-1] = codes - 1
    pos = rng.integers(0, n - 1, size=b).astype(np.int32)
    m_pad = -(-m // 4) * 4
    lengths = rng.integers(1, m + 1, size=b)
    sym = rng.integers(0, codes, size=(b, m_pad)).astype(np.int32)
    for i in range(0, b, 3):  # plant suffixes: verdict 0 (or ±1 at the end)
        seg = s[pos[i]:pos[i] + m_pad]
        sym[i, :seg.size] = seg
    valid = np.arange(m_pad)[None, :] < lengths[:, None]
    pat, mask = _byte_words(sym, valid)
    pallas = j_probe_bytes(jnp.asarray(s), jnp.asarray(pos), jnp.asarray(pat),
                           jnp.asarray(mask), tile=tile, interpret=True)
    want = jref.pattern_probe_ref(jnp.asarray(s), jnp.asarray(pos),
                                  jnp.asarray(pat), jnp.asarray(mask))
    got = tprobe.pattern_probe(torch.from_numpy(s), torch.from_numpy(pos),
                               torch.from_numpy(pat), torch.from_numpy(mask))
    np.testing.assert_array_equal(np.asarray(pallas), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(got.numpy().tolist()) <= {-1, 0, 1} and (got.numpy() == 0).any()


def test_pattern_probe_prefix_match_is_zero():
    s = np.array([0, 1, 2, 3, 0, 1, 2, 4], np.uint8)
    pat_sym = np.zeros((3, 4), np.int32)
    pat_sym[:, :2] = [1, 2]
    valid = np.broadcast_to(np.arange(4)[None, :] < 2, (3, 4))
    pat, mask = _byte_words(pat_sym, valid)
    pos = np.array([1, 5, 0], np.int32)
    pallas = j_probe_bytes(jnp.asarray(s), jnp.asarray(pos), jnp.asarray(pat),
                           jnp.asarray(mask), tile=32, interpret=True)
    got = ops.pattern_probe(torch.from_numpy(s), torch.from_numpy(pos),
                            torch.from_numpy(pat), torch.from_numpy(mask))
    np.testing.assert_array_equal(np.asarray(pallas), [0, 0, -1])
    np.testing.assert_array_equal(got.numpy(), [0, 0, -1])


@pytest.mark.parametrize("alpha,n,b,m", [
    (DNA, 400, 19, 4), (PROTEIN_CLASS, 700, 33, 8), (BYTE, 500, 16, 12),
], ids=lambda v: getattr(v, "name", v))
def test_pattern_probe_packed_equal(alpha, n, b, m):
    """Plain port version == JAX Pallas (interpret) == the JAX byte probe
    on the terminal-padded string, terminal codes in the patterns."""
    rng = np.random.default_rng(n + b)
    s = alpha.random_string(n, seed=n)
    jt = jpk.pack_text(s, alpha, extra=32)
    tt = tpk.pack_text(s, ALPHABETS[alpha.name], extra=32, device="cpu")
    sp = alpha.pad_string(s, extra=32)
    pos = rng.integers(0, n, size=b).astype(np.int32)
    pos[-3:] = [n - 2, n - 1, n]  # suffixes running into the terminal
    m_pad = -(-m // 4) * 4
    lengths = rng.integers(1, m + 1, size=b)
    sym = rng.integers(0, alpha.base, size=(b, m_pad)).astype(np.int32)
    for i in range(0, b, 4):
        sym[i] = sp[pos[i]:pos[i] + m_pad]
    valid = np.arange(m_pad)[None, :] < lengths[:, None]
    pat, mask = _byte_words(sym, valid)
    pallas = j_probe_packed(jt, jnp.asarray(pos), jnp.asarray(pat),
                            jnp.asarray(mask), tile=32, interpret=True)
    want = jref.pattern_probe_ref(jnp.asarray(sp), jnp.asarray(pos),
                                  jnp.asarray(pat), jnp.asarray(mask))
    jref_packed = jref.pattern_probe_packed_ref(jt, jnp.asarray(pos),
                                                jnp.asarray(pat),
                                                jnp.asarray(mask))
    got = tpg.pattern_probe_packed(tt, torch.from_numpy(pos),
                                   torch.from_numpy(pat),
                                   torch.from_numpy(mask))
    np.testing.assert_array_equal(np.asarray(pallas), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(jref_packed), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _no_fallback_calls():
    """Each byte-currency wrapper with CPU stand-ins for card tensors."""
    rng = np.random.default_rng(2)
    s = torch.from_numpy(DNA.pad_string(DNA.random_string(200, seed=1), 40))
    pt = tpk.pack_text(DNA.random_string(200, seed=1), ALPHABETS["dna"],
                       extra=40, device="cpu")
    pos = torch.from_numpy(rng.integers(0, 200, 8).astype(np.int32))
    words = torch.zeros((8, 2), dtype=torch.int32)
    return {
        "range_gather_pack": (trg, lambda: trg.range_gather_pack(s, pos, 8)),
        "range_gather_pack:mask": (trg, lambda: trg.range_gather_pack(
            s, pos, 8, mask=pos > 50)),
        "range_gather_words": (tpg, lambda: tpg.range_gather_words(
            pt, pos, 16)),
        "range_gather_words:mask": (tpg, lambda: tpg.range_gather_words(
            pt, pos, 16, mask=pos > 50)),
        "lcp_pairs": (tlcp, lambda: tlcp.lcp_pairs(words, words, 8)),
        "pattern_probe": (tprobe, lambda: tprobe.pattern_probe(
            s, pos, words, words)),
        "pattern_probe_packed": (tpg, lambda: tpg.pattern_probe_packed(
            pt, pos, words, words)),
        "range_gather_packed": (tpg, lambda: tpg.range_gather_packed(
            pt, pos, 8)),
        "range_gather_packed:mask": (tpg, lambda: tpg.range_gather_packed(
            pt, pos, 8, mask=pos > 50)),
        "suffix_lcp_words": (tpg, lambda: tpg.suffix_lcp_words(
            pt, pos, pos, 8)),
        "suffix_lcp_pairs": (tslcp, lambda: tslcp.suffix_lcp_pairs(
            s, pos, pos, 8)),
        "probe_gather_words": (tfused, lambda: tfused.probe_gather_words(
            pt, pos, words, words, pos, 16)),
        "probe_gather_packed": (tfused, lambda: tfused.probe_gather_packed(
            pt, pos, words, words, 16)),
        "flash_attention": (tflash, lambda: tflash.flash_attention(
            torch.zeros((1, 8, 4, 16)), torch.zeros((1, 8, 2, 16)),
            torch.zeros((1, 8, 2, 16)))),
        "search_bounds_words": (tsearch, lambda: tsearch.search_bounds_words(
            pt, pos, words, words, pos, None, pos, pos + 3, n_iter=4,
            bounds=2)),
        "search_bounds_bytes": (tsearch, lambda: tsearch.search_bounds_bytes(
            s, pos, words, words, pos, pos + 3, n_iter=4, bounds=1)),
        "search_bounds_packed": (tsearch,
                                 lambda: tsearch.search_bounds_packed(
            pt, pos, words, words, pos, pos + 3, n_iter=4, bounds=2)),
        "search_fetch_packed": (tsearch, lambda: tsearch.search_fetch_packed(
            pt, pos, words, words, pos, pos + 3, n_iter=4, fetch=8)),
        "kmer_histogram": (tkmer, lambda: tkmer.kmer_histogram(s, 100, 3, 5)),
    }


@pytest.mark.parametrize("kernel", ["range_gather_pack", "lcp_pairs",
                                    "pattern_probe", "pattern_probe_packed",
                                    "range_gather_packed", "suffix_lcp_words",
                                    "suffix_lcp_pairs", "probe_gather_words",
                                    "probe_gather_packed", "flash_attention",
                                    "search_bounds_words",
                                    "search_bounds_bytes",
                                    "search_bounds_packed",
                                    "search_fetch_packed",
                                    "range_gather_pack:mask",
                                    "range_gather_words",
                                    "range_gather_words:mask",
                                    "range_gather_packed:mask",
                                    "kmer_histogram"])
def test_card_tensors_never_fall_back(monkeypatch, kernel):
    """A tensor that is not on the CPU goes to the hand kernel: when the
    build fails the wrapper raises, and neither the plain version nor the
    launch count (nor a gather's row tally) is touched.  ``:mask`` cases
    pass the elastic step's row mask."""
    module, call = _no_fallback_calls()[kernel]
    kernel = kernel.split(":")[0]
    monkeypatch.setattr(module, "_on_cpu", lambda *tensors: False)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_ENTRIES", {})

    def failed_build():
        raise RuntimeError("CUDA kernel build failed: stand-in")

    def plain(*args, **kw):
        raise AssertionError("the plain version ran for a card tensor")

    monkeypatch.setattr(_build, "build_all", failed_build)
    for name in ("range_gather_pack_ref", "lcp_pairs_ref", "pattern_probe_ref",
                 "pattern_probe_packed_ref", "range_gather_packed_ref",
                 "suffix_lcp_words_ref", "suffix_lcp_pairs_ref",
                 "probe_gather_words_ref", "probe_gather_packed_ref",
                 "flash_attention_ref", "pattern_probe_words_ref",
                 "range_gather_words_ref", "kmer_histogram_ref"):
        monkeypatch.setattr(tref, name, plain)
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="build failed"):
        call()
    assert ops.launch_counts()[kernel] == 0
    if kernel in ("range_gather_words", "range_gather_pack",
                  "range_gather_packed"):
        assert (ops.KERNELS[kernel].rows, ops.KERNELS[kernel].words) == (0, 0)
    if kernel == "suffix_lcp_words":
        assert (tpg.suffix_lcp_words.rows,
                tpg.suffix_lcp_words.words_read) == (0, 0)
    if kernel == "kmer_histogram":
        assert tkmer.kmer_histogram.last_path is None


def test_byte_wrappers_check_card_inputs(monkeypatch):
    """The checks a card call makes before any launch."""
    monkeypatch.setattr(trg, "_on_cpu", lambda *tensors: False)
    with pytest.raises(ValueError, match="uint8"):
        trg.range_gather_pack(torch.zeros(16, dtype=torch.int32),
                              torch.zeros(2, dtype=torch.int32), 8)
    with pytest.raises(ValueError, match="multiple of 4"):
        trg.range_gather_pack(torch.zeros(16, dtype=torch.uint8),
                              torch.zeros(2, dtype=torch.int32), 6)
    with pytest.raises(ValueError, match="rows"):
        ops.lcp_pairs(torch.zeros((3, 2), dtype=torch.int32),
                      torch.zeros((3, 1), dtype=torch.int32), 8)
    # the LCP kernel's aligned 16-byte reads: an offset view is refused,
    # not read through another path
    monkeypatch.setattr(tslcp, "_on_cpu", lambda *tensors: False)
    pos = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="16 bytes"):
        tslcp.suffix_lcp_pairs(torch.zeros(68, dtype=torch.uint8)[4:], pos,
                               pos, 8)


def test_cpu_tensors_take_plain_versions_uncounted():
    ops.reset_launch_counts()
    s, jt, tt = _texts(DNA, 300, 24, seed=2)
    offs = torch.arange(0, 300, 7, dtype=torch.int32)
    ops.range_gather_words(tt, offs, 16)
    ops.kmer_histogram(torch.zeros(20, dtype=torch.uint8), 10, 2, 5)
    sp = torch.from_numpy(DNA.pad_string(s, 24))
    keys = ops.range_gather_pack(sp, offs, 16)
    ops.lcp_pairs(keys, keys, 16)
    ops.pattern_probe(sp, offs, keys, keys)
    ops.pattern_probe_packed(tt, offs, keys, keys)
    ops.range_gather_packed(tt, offs, 16)
    ops.suffix_lcp_words(tt, offs, offs.flip(0), 16)
    ops.KERNELS["suffix_lcp_pairs"](sp, offs, offs.flip(0), 16)
    dense = torch.zeros((offs.shape[0], 1), dtype=torch.int32)
    ops.probe_gather_words(tt, offs, dense, dense, offs, 16)
    ops.probe_gather_packed(tt, offs, keys, keys, 16)
    ops.flash_attention(torch.zeros((1, 4, 2, 16)), torch.zeros((1, 4, 1, 16)),
                        torch.zeros((1, 4, 1, 16)))
    ops.search_bounds_words(tt, offs, dense, dense, offs, None, offs,
                            offs + 5, n_iter=3, bounds=2)
    ops.search_bounds_bytes(sp, offs, keys, keys, offs, offs + 5, n_iter=3,
                            bounds=1)
    ops.search_fetch_words(tt, offs, dense, dense, offs, offs, offs + 5,
                           n_iter=3, fetch=16)
    ops.search_fetch_bytes(sp, offs, keys, keys, offs, offs + 5, n_iter=3,
                           fetch=16)
    ops.search_bounds_packed(tt, offs, keys, keys, offs, offs + 5, n_iter=3,
                             bounds=2)
    ops.search_fetch_packed(tt, offs, keys, keys, offs, offs + 5, n_iter=3,
                            fetch=16)
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}
    assert len(ops.KERNELS) == 19


def test_reset_clears_range_gather_pack_tallies(monkeypatch):
    """``reset_launch_counts`` also zeroes the rows and key words that
    ``range_gather_pack``'s launches gathered, which CPU calls never add
    to."""
    monkeypatch.setattr(trg.range_gather_pack, "rows", 7)
    monkeypatch.setattr(trg.range_gather_pack, "words", 21)
    ops.reset_launch_counts()
    assert (trg.range_gather_pack.rows, trg.range_gather_pack.words) == (0, 0)
    sp = torch.from_numpy(DNA.pad_string(DNA.random_string(100, seed=1), 24))
    ops.range_gather_pack(sp, torch.arange(0, 90, 3, dtype=torch.int32), 16)
    assert (trg.range_gather_pack.rows, trg.range_gather_pack.words) == (0, 0)


def test_reset_clears_range_gather_words_tallies(monkeypatch):
    """``reset_launch_counts`` zeroes the rows and words that
    ``range_gather_words``' launches gathered; CPU calls, masked or not,
    never add to them."""
    monkeypatch.setattr(tpg.range_gather_words, "rows", 11)
    monkeypatch.setattr(tpg.range_gather_words, "words", 44)
    ops.reset_launch_counts()
    assert (tpg.range_gather_words.rows, tpg.range_gather_words.words) == (0, 0)
    s, jt, tt = _texts(DNA, 200, 72, seed=3)
    offs = torch.arange(0, 190, 7, dtype=torch.int32)
    ops.range_gather_words(tt, offs, 64)
    ops.range_gather_words(tt, offs, 16, mask=offs > 40)
    assert (tpg.range_gather_words.rows, tpg.range_gather_words.words) == (0, 0)
    assert tpg.range_gather_words.launches == 0


def test_gather_wrappers_check_masks(monkeypatch):
    """A card call refuses a mask that is not one bool per row."""
    s, jt, tt = _texts(DNA, 200, 72, seed=3)
    sp = torch.from_numpy(DNA.pad_string(s, 72))
    offs = torch.arange(0, 40, dtype=torch.int32)
    monkeypatch.setattr(tpg, "_on_cpu", lambda *tensors: False)
    monkeypatch.setattr(trg, "_on_cpu", lambda *tensors: False)
    for bad, what in ((torch.ones(39, dtype=torch.bool), "rows"),
                      (torch.ones(40, dtype=torch.uint8), "bool")):
        with pytest.raises(ValueError, match=what):
            tpg.range_gather_words(tt, offs, 16, mask=bad)
        with pytest.raises(ValueError, match=what):
            trg.range_gather_pack(sp, offs, 16, mask=bad)


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
    assert not ops._use_word_compare()  # the byte-key oracle now runs
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


def _lcp_pairs_inputs(alpha, n, b, w, rng):
    """A string with a planted copy (long shared prefixes), and pairs:
    random, inside the copy, equal, and within ``w`` of the end."""
    s = alpha.random_string(n, seed=n + w)
    s[n // 2:n // 2 + 3 * w // 2] = s[7:7 + 3 * w // 2]
    pa = rng.integers(0, n + 1, size=b)
    pb = rng.integers(0, n + 1, size=b)
    k = b // 4
    pa[:k] = 7 + rng.integers(0, w // 2, size=k)
    pb[:k] = pa[:k] + (n // 2 - 7)
    pa[k:k + 8] = rng.integers(max(0, n - w), n + 1, size=8)
    pb[k:k + 8] = rng.integers(max(0, n - w), n + 1, size=8)
    pb[k + 8:k + 11] = pa[k + 8:k + 11]
    return s, pa.astype(np.int32), pb.astype(np.int32)


@pytest.mark.parametrize("alpha,n,f,w,tile", [
    (DNA, 900, 33, 16, 32), (DNA, 1200, 24, 256, 64),
    (PROTEIN_CLASS, 800, 21, 32, 64), (BYTE, 500, 16, 8, 32),
], ids=lambda v: getattr(v, "name", v))
def test_range_gather_packed_equal(alpha, n, f, w, tile):
    """Plain port version == JAX Pallas (interpret) == JAX ref == the byte
    keys of the terminal-padded string, offsets up to n included."""
    rng = np.random.default_rng(n + f + w)
    s, jt, tt = _texts(alpha, n, w + 8, seed=n)
    offs = np.concatenate([rng.integers(0, n, size=f),
                           np.arange(n - 5, n + 1)]).astype(np.int32)
    pallas = j_gather_packed(jt, jnp.asarray(offs), w, tile=tile,
                             interpret=True)
    want = jref.range_gather_packed_ref(jt, jnp.asarray(offs), w)
    oracle = jref.range_gather_pack_ref(
        jnp.asarray(alpha.pad_string(s, extra=w + 8)), jnp.asarray(offs), w)
    got = tpg.range_gather_packed(tt, torch.from_numpy(offs), w)
    np.testing.assert_array_equal(np.asarray(pallas), np.asarray(oracle))
    np.testing.assert_array_equal(np.asarray(want), np.asarray(oracle))
    np.testing.assert_array_equal(got.numpy(), np.asarray(oracle))
    assert ops.range_gather(tt, torch.from_numpy(offs), w).equal(got)


@pytest.mark.parametrize("alpha,n,b,w,tile", [
    (DNA, 1200, 48, 64, 64), (DNA, 1500, 32, 256, 64),
    (PROTEIN_CLASS, 800, 40, 4, 32), (BYTE, 600, 32, 16, 32),
], ids=lambda v: getattr(v, "name", v))
def test_suffix_lcp_words_equal(alpha, n, b, w, tile):
    """Word LCP: plain port version == JAX Pallas (interpret) == JAX ref,
    and == the byte symbol scan on distinct pairs."""
    rng = np.random.default_rng(n + b + w)
    s, pa, pb = _lcp_pairs_inputs(alpha, n, b, w, rng)
    jt = jpk.pack_text(s, alpha, extra=w + 8)
    tt = tpk.pack_text(s, ALPHABETS[alpha.name], extra=w + 8, device="cpu")
    ja, jb = jnp.asarray(pa), jnp.asarray(pb)
    pallas = np.asarray(j_lcp_words(jt, ja, jb, w, tile=tile, interpret=True))
    want = np.asarray(jref.suffix_lcp_words_ref(jt, ja, jb, w))
    got = tpg.suffix_lcp_words(tt, torch.from_numpy(pa), torch.from_numpy(pb),
                               w).numpy()
    np.testing.assert_array_equal(pallas, want)
    np.testing.assert_array_equal(got, want)
    if w % 4 == 0:
        byte = np.asarray(jref.suffix_lcp_pairs_ref(
            jnp.asarray(alpha.pad_string(s, extra=w + 8)), ja, jb, w))
        distinct = pa != pb
        np.testing.assert_array_equal(got[distinct], byte[distinct])
    assert (got == w).any() and (got < w).any()


def _chain_pairs(n, b, chain, rng):
    """Pairs of distinct positions in ``[0, n]`` where ``pos_a[i + 1] ==
    pos_b[i]`` along the whole batch (``full``), along runs broken every
    few rows (``partial``), or nowhere (``none``); the last rows sit at
    ``n - 1`` and ``n`` (the text's end)."""
    chainpos = rng.permutation(n + 1)[:b + 1].astype(np.int32)
    pa, pb = chainpos[:-1].copy(), chainpos[1:].copy()
    if chain == "partial":
        for i in range(3, b, 5):  # break the chain before row i
            pa[i] = (pb[i - 1] + 1 + rng.integers(0, n)) % (n + 1)
    elif chain == "none":
        pa = np.roll(pb, 7) + 1
        pa[pa > n] = 0
    pa[-4:] = [n - 1, n, n - 1, n]
    pb[-4:] = [n, n - 1, n - 2, 3]
    keep = pa != pb
    return pa[keep], pb[keep]


@pytest.mark.parametrize("chain", ["full", "partial", "none"])
@pytest.mark.parametrize("w", [128, 256])
@pytest.mark.parametrize("alpha", [DNA, PROTEIN_CLASS, BYTE],
                         ids=lambda a: a.name)
def test_suffix_lcp_words_chains(alpha, w, chain):
    """Word LCP on adjacency chains (the card kernel takes a shared
    suffix's words from its neighbour lane) and on pairs at the text's
    end, on a periodic text whose pairs saturate: plain port version ==
    JAX Pallas (interpret) == JAX ref, at bits 2, 4 and 8."""
    rng = np.random.default_rng(w + len(chain) + alpha.base)
    n = 700
    s = alpha.random_string(n, seed=3)
    s[:n] = np.tile(s[:23], n // 23 + 1)[:n]  # period 23, then the terminal
    s[:n:97] = alpha.random_string(n, seed=4)[:n:97]  # a few mismatches
    pa, pb = _chain_pairs(n, 96, chain, rng)
    pa[:8] = np.arange(8) * 23 + 5  # long shared prefixes, chained
    pb[:8] = pa[:8] + 23
    jt = jpk.pack_text(s, alpha, extra=w + 8)
    tt = tpk.pack_text(s, ALPHABETS[alpha.name], extra=w + 8, device="cpu")
    ja, jb = jnp.asarray(pa), jnp.asarray(pb)
    pallas = np.asarray(j_lcp_words(jt, ja, jb, w, tile=128, interpret=True))
    want = np.asarray(jref.suffix_lcp_words_ref(jt, ja, jb, w))
    got = tpg.suffix_lcp_words(tt, torch.from_numpy(pa), torch.from_numpy(pb),
                               w).numpy()
    np.testing.assert_array_equal(pallas, want)
    np.testing.assert_array_equal(got, want)
    shared = (pa[1:] == pb[:-1]).mean()
    assert {"full": shared > 0.85, "partial": 0.5 < shared < 0.85,
            "none": shared < 0.1}[chain]
    assert (got > 64).any() and got[-2] <= 1 and not got[[-4, -3, -1]].any()


@pytest.mark.parametrize("alpha,n,b,w,extra", [
    (DNA, 700, 40, 4, 8), (PROTEIN_CLASS, 900, 48, 64, 72),
    (BYTE, 800, 32, 256, 8), (BYTE, 500, 40, 16, 24),
], ids=lambda v: getattr(v, "name", v))
def test_suffix_lcp_pairs_equal(alpha, n, b, w, extra):
    """Byte-text LCP: plain port version == JAX Pallas (interpret) == JAX
    ref, with reads running past a short padding (clamped alike)."""
    rng = np.random.default_rng(n + b + w)
    s, pa, pb = _lcp_pairs_inputs(alpha, n, b, w, rng)
    sp = alpha.pad_string(s, extra=extra)
    ja, jb = jnp.asarray(pa), jnp.asarray(pb)
    pallas = np.asarray(j_suffix_lcp(jnp.asarray(sp), ja, jb, w, tile=64,
                                     interpret=True))
    want = np.asarray(jref.suffix_lcp_pairs_ref(jnp.asarray(sp), ja, jb, w))
    got = tslcp.suffix_lcp_pairs(torch.from_numpy(sp), torch.from_numpy(pa),
                                 torch.from_numpy(pb), w).numpy()
    np.testing.assert_array_equal(pallas, want)
    np.testing.assert_array_equal(got, want)
    assert (got == w).any() and (got < w).any()


@pytest.mark.parametrize("leg", ["word", "byte"])
@pytest.mark.parametrize("alpha", [DNA, PROTEIN_CLASS, BYTE],
                         ids=lambda a: a.name)
def test_suffix_lcp_dispatch_equal(monkeypatch, leg, alpha):
    """``ops.suffix_lcp_pairs`` follows the JAX dispatch branch for branch:
    dense text (word kernel or the byte-key oracle) and byte text."""
    monkeypatch.setenv("REPRO_WORD_COMPARE", leg)
    rng = np.random.default_rng(5)
    w = 32
    s, pa, pb = _lcp_pairs_inputs(alpha, 700, 40, w, rng)
    jt = jpk.pack_text(s, alpha, extra=w + 8)
    tt = tpk.pack_text(s, ALPHABETS[alpha.name], extra=w + 8, device="cpu")
    sp = alpha.pad_string(s, extra=w + 8)
    ta, tb = torch.from_numpy(pa), torch.from_numpy(pb)
    for jtext, ttext in ((jt, tt), (jnp.asarray(sp), torch.from_numpy(sp))):
        want = np.asarray(jops.suffix_lcp_pairs(jtext, jnp.asarray(pa),
                                                jnp.asarray(pb), w))
        got = ops.suffix_lcp_pairs(ttext, ta, tb, w)
        np.testing.assert_array_equal(got.numpy(), want)


def test_suffix_lcp_wrappers_check_inputs(monkeypatch):
    """The checks a card call makes before any launch."""
    pos = torch.zeros(3, dtype=torch.int32)
    s = torch.zeros(64, dtype=torch.uint8)
    with pytest.raises(ValueError, match="multiple of 4"):
        tslcp.suffix_lcp_pairs(s, pos, pos, 6)
    with pytest.raises(ValueError, match="equal 1-D"):
        tslcp.suffix_lcp_pairs(s, pos, pos[:2], 8)
    with pytest.raises(ValueError, match="multiple of 4"):
        ops.range_gather_packed(tpk.pack_text(DNA.random_string(50, seed=1),
                                              ALPHABETS["dna"], extra=16,
                                              device="cpu"), pos, 6)
    monkeypatch.setattr(tslcp, "_on_cpu", lambda *tensors: False)
    with pytest.raises(ValueError, match="uint8"):
        tslcp.suffix_lcp_pairs(s.to(torch.int32), pos, pos, 8)


FUSED_CASES = [
    (DNA, 900, 24, 8, 32),          # fetch wider than the pattern
    (DNA, 700, 16, 16, 4),          # fetch narrower than the pattern
    (PROTEIN_CLASS, 700, 20, 8, 16),
    (BYTE, 500, 12, 12, 12),
]


def _fused_batch(alpha, n, b, m, seed):
    """The probe workload of ``tests/test_packed.py::TestFusedProbeGather``:
    terminal-tail positions and planted exact matches, in both packages."""
    rng = np.random.default_rng(seed)
    s = alpha.random_string(n, seed=n)
    jt = jpk.pack_text(s, alpha, extra=96)
    tt = tpk.pack_text(s, ALPHABETS[alpha.name], extra=96, device="cpu")
    sp = alpha.pad_string(s, extra=96)
    pos = np.concatenate([rng.integers(0, n, size=b - 4),
                          rng.integers(max(0, n - m), n + 1, 4)]
                         ).astype(np.int32)
    m_pad = -(-m // 4) * 4
    lengths = rng.integers(1, m + 1, size=len(pos)).astype(np.int32)
    sym = rng.integers(0, len(alpha.symbols),
                       size=(len(pos), m_pad)).astype(np.int32)
    for i in range(0, len(pos), 3):
        j = int(rng.integers(0, n - m_pad))
        sym[i] = sp[j : j + m_pad]
        pos[i] = j
    valid = np.arange(m_pad)[None, :] < lengths[:, None]
    return jt, tt, pos, np.where(valid, sym, 0), valid, lengths


@pytest.mark.parametrize("alpha,n,b,m,fetch", FUSED_CASES,
                         ids=lambda v: getattr(v, "name", v))
def test_probe_gather_words_equal(alpha, n, b, m, fetch):
    """Plain port version == JAX Pallas (interpret) == the two-launch
    composition of the port's word probe and word gather."""
    jt, tt, pos, sym, valid, lengths = _fused_batch(alpha, n, b, m, n + m)
    bits = jt.bits
    pat_j = jpk.pack_pattern_dense(jnp.asarray(sym), bits, jt.terminal)
    mask_j = jpk.pack_dense(jnp.asarray(np.where(valid, (1 << bits) - 1, 0)),
                            bits)
    cmp_j, win_j = j_fused_words(jt, jnp.asarray(pos), pat_j, mask_j,
                                 jnp.asarray(lengths), fetch=fetch, tile=64,
                                 interpret=True)
    pat_t = tpk.pack_pattern_dense(torch.from_numpy(sym), bits, tt.terminal)
    mask_t = tpk.pack_dense(torch.from_numpy(
        np.where(valid, (1 << bits) - 1, 0)), bits)
    np.testing.assert_array_equal(tpk.words_to_numpy(pat_t), np.asarray(pat_j))
    pos_t, len_t = torch.from_numpy(pos), torch.from_numpy(lengths)
    cmp_t, win_t = tfused.probe_gather_words(tt, pos_t, pat_t, mask_t, len_t,
                                             fetch)
    np.testing.assert_array_equal(cmp_t.numpy(), np.asarray(cmp_j))
    np.testing.assert_array_equal(tpk.words_to_numpy(win_t), np.asarray(win_j))
    assert win_t.shape == (b, -(-fetch // tt.syms_per_word))
    two = (tpg.pattern_probe_words(tt, pos_t, pat_t, mask_t, len_t),
           tpg.range_gather_words(tt, pos_t, fetch))
    assert cmp_t.equal(two[0]) and win_t.equal(two[1])
    assert set(cmp_t.tolist()) >= {0}


@pytest.mark.parametrize("alpha,n,b,m,fetch", FUSED_CASES,
                         ids=lambda v: getattr(v, "name", v))
def test_probe_gather_packed_equal(alpha, n, b, m, fetch):
    """Plain port version == JAX Pallas (interpret) == the two-launch
    composition of the port's packed probe and packed gather."""
    jt, tt, pos, sym, valid, _ = _fused_batch(alpha, n, b, m, 2 * n + m)
    pat, mask = _byte_words(sym, valid)
    cmp_j, win_j = j_fused_packed(jt, jnp.asarray(pos), jnp.asarray(pat),
                                  jnp.asarray(mask), fetch=fetch, tile=64,
                                  interpret=True)
    pos_t = torch.from_numpy(pos)
    pat_t, mask_t = torch.from_numpy(pat), torch.from_numpy(mask)
    cmp_t, win_t = tfused.probe_gather_packed(tt, pos_t, pat_t, mask_t, fetch)
    np.testing.assert_array_equal(cmp_t.numpy(), np.asarray(cmp_j))
    np.testing.assert_array_equal(win_t.numpy(), np.asarray(win_j))
    two = (tpg.pattern_probe_packed(tt, pos_t, pat_t, mask_t),
           tpg.range_gather_packed(tt, pos_t, fetch))
    assert cmp_t.equal(two[0]) and win_t.equal(two[1])


@pytest.mark.parametrize("leg", ["word", "byte"])
def test_probe_gather_dispatch_equal(monkeypatch, leg):
    """Each storage's find-and-fetch pair gives what JAX's
    ``ops.probe_gather`` dispatches to: the fused ``probe_gather_packed``
    on dense text, ``pattern_probe`` + ``range_gather_pack`` on the byte
    string, with equal results for either storage."""
    monkeypatch.setenv("REPRO_WORD_COMPARE", leg)
    alpha, n, b, m, fetch = DNA, 600, 16, 8, 16
    jt, tt, pos, sym, valid, _ = _fused_batch(alpha, n, b, m, 99)
    sp = alpha.pad_string(alpha.random_string(n, seed=n), extra=96)
    pat, mask = _byte_words(sym, valid)
    args_j = (jnp.asarray(pos), jnp.asarray(pat), jnp.asarray(mask))
    args_t = (torch.from_numpy(pos), torch.from_numpy(pat),
              torch.from_numpy(mask))
    dense_t = ops.probe_gather_packed(tt, *args_t, fetch)
    sp_t = torch.from_numpy(sp)
    byte_t = (ops.pattern_probe(sp_t, *args_t),
              ops.range_gather_pack(sp_t, args_t[0], fetch))
    for text_j, got in ((jt, dense_t), (jnp.asarray(sp), byte_t)):
        want = jops.probe_gather(text_j, *args_j, fetch)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert dense_t[0].equal(byte_t[0]) and dense_t[1].equal(byte_t[1])


def test_probe_gather_wrappers_check_card_inputs(monkeypatch):
    """The checks a card call makes before any launch: the read covers
    max(pattern, fetch) symbols, byte-key windows need fetch % 4 == 0."""
    pt = tpk.pack_text(DNA.random_string(100, seed=1), ALPHABETS["dna"],
                       extra=16, device="cpu")
    pos = torch.zeros(3, dtype=torch.int32)
    one = torch.zeros((3, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 4"):
        tfused.probe_gather_packed(pt, pos, one, one, 6)
    monkeypatch.setattr(tfused, "_on_cpu", lambda *tensors: False)
    with pytest.raises(ValueError, match="larger extra"):
        tfused.probe_gather_words(pt, pos, one, one, pos, 64)
    with pytest.raises(ValueError, match="larger extra"):
        tfused.probe_gather_packed(pt, pos, one, one, 64)
    with pytest.raises(ValueError, match="row counts"):
        tfused.probe_gather_words(pt, pos, one, one, pos[:2], 8)


# ---- flash_attention: the plain version against the Pallas kernel ---------
# Float tolerances: in float32 the JAX test's own (rtol 1e-5, atol 2e-5),
# since the kernel's online softmax sums in another order than one softmax
# over the row; in bfloat16 one bf16 ulp of each output (rtol 2^-7, since
# ulp(x) <= 2^-7 |x| and both round an f32 result to bf16 once) plus the
# float32 atol 2e-5 for outputs near 0.

FLASH_SHAPES = [  # tests/test_flash_and_packed.py's sweep
    (2, 128, 4, 2, 32, 32, 64, True),
    (1, 256, 8, 8, 64, 64, 128, True),
    (2, 128, 4, 1, 32, 64, 32, False),
    (1, 64, 2, 2, 16, 16, 16, True),
    (2, 96, 4, 4, 32, 32, 32, True),
]


def _qkv(b, sq, sk, h, kv, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, d)).astype(dtype),
            rng.normal(size=(b, sk, kv, d)).astype(dtype),
            rng.normal(size=(b, sk, kv, d)).astype(dtype))


@pytest.mark.parametrize("b,s,h,kv,d,bq,bk,causal", FLASH_SHAPES)
@pytest.mark.parametrize("flip", [False, True], ids=["as_listed", "flipped"])
def test_flash_attention_ref_matches_pallas(b, s, h, kv, d, bq, bk, causal,
                                            flip):
    causal = causal != flip  # each shape with both causal flags
    q, k, v = _qkv(b, s, s, h, kv, d, seed=s * h)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, blk_q=bq, blk_k=bk, interpret=True)
    got = tflash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (b, s, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-5)


@pytest.mark.parametrize("sq,sk,bq,bk,causal", [
    (64, 128, 32, 64, True), (128, 64, 32, 32, True), (64, 128, 64, 32, False),
])
def test_flash_attention_ref_uneven_lengths(sq, sk, bq, bk, causal):
    """Sq != Sk where the Pallas kernel takes it: row i sees keys j <= i,
    both counted from 0."""
    q, k, v = _qkv(2, sq, sk, 4, 2, 32, seed=sq + sk)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, blk_q=bq, blk_k=bk, interpret=True)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-5)


def test_flash_attention_ref_bf16():
    """tests/test_flash_and_packed.py::test_bf16's case, output in bf16."""
    q, k, v = _qkv(1, 128, 128, 4, 2, 32, seed=1)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(j_flash(jq, jk, jv, blk_q=32, blk_k=64, interpret=True),
                      np.float32)
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
                  for x in (jq, jk, jv))
    got = tflash.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                               atol=2e-5)


@pytest.mark.parametrize("dtype,design,lib", [
    (torch.bfloat16, "wgmma_tma", "flash_attention_sm90"),
    (torch.float32, "cuda_cores", "flash_attention")], ids=["bf16", "f32"])
def test_flash_attention_routes_by_dtype(monkeypatch, dtype, design, lib):
    """A card call asks for the entry point of its dtype's design (bf16:
    the wgmma + TMA kernel) and nothing else: when that entry point is
    missing the call raises, with no other kernel, no plain version and
    no launch counted."""
    assert tflash.ROUTES[dtype] == (design, lib)
    assert lib in _build.SOURCES
    assert (_build.CSRC / f"{lib}.cu").exists()
    monkeypatch.setattr(tflash, "_on_cpu", lambda *tensors: False)
    asked = []

    def entry(name, argtypes):
        asked.append(name)
        raise LookupError(f"no entry point {name}")

    def plain(*args, **kw):
        raise AssertionError("the plain version ran for a card tensor")

    monkeypatch.setattr(_build, "entry", entry)
    monkeypatch.setattr(tref, "flash_attention_ref", plain)
    monkeypatch.setattr(tflash.flash_attention, "route", None)
    ops.reset_launch_counts()
    q, k = torch.zeros((1, 8, 4, 16), dtype=dtype), torch.zeros(
        (1, 8, 2, 16), dtype=dtype)
    with pytest.raises(LookupError, match=lib):
        tflash.flash_attention(q, k, k)
    assert asked == [lib]
    assert ops.launch_counts()["flash_attention"] == 0
    assert tflash.flash_attention.route is None


def test_flash_attention_checks_card_inputs(monkeypatch):
    """The checks a card call makes before any build or launch."""
    monkeypatch.setattr(tflash, "_on_cpu", lambda *tensors: False)
    q, k = torch.zeros((1, 8, 4, 24)), torch.zeros((1, 8, 2, 24))
    with pytest.raises(ValueError, match="multiple of 16"):
        tflash.flash_attention(q, k, k)
    q, k = torch.zeros((1, 8, 4, 272)), torch.zeros((1, 8, 2, 272))
    with pytest.raises(ValueError, match="multiple of 16"):
        tflash.flash_attention(q, k, k)
    q, k = torch.zeros((1, 8, 4, 16)), torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="float32 or all"):
        tflash.flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(ValueError, match="float32 or all"):
        tflash.flash_attention(q, k.bfloat16(), k.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        tflash.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                               k, k)
    with pytest.raises(ValueError, match="Sq, Sk >= 1"):
        tflash.flash_attention(q[:, :0], k, k)
    with pytest.raises(ValueError, match="multiple of KV"):
        tflash.flash_attention(torch.zeros((1, 8, 3, 16)), k, k)

"""The port's hand-written CUDA kernels against their plain versions, on a card.

Each test carries the ``cuda`` marker and skips without an NVIDIA card
(the kernels have no CPU mode); run them on the card with
``python -m pytest -m cuda tests/test_torch_cuda.py``.  The file imports
no JAX, so it also runs where only PyTorch is installed.  Tolerance:
exact for the integer kernels; ``flash_attention`` states its own.
"""

import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import packing as tpk
from repro_torch.core.alphabet import ALPHABETS
from repro_torch.core.query import _pack_query_batch, _route_window
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
from repro_torch.models import transformer as T
from repro_torch.models.config import smoke_config
from repro_torch.models.registry import get_config


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", ["dna", "protein_class"])
def test_cuda_range_gather_words(cuda_device, alpha):
    a = ALPHABETS[alpha]
    s = a.random_string(50_000, seed=1)
    pt = tpk.pack_text(s, a, extra=264, device=cuda_device)
    offs = torch.randint(0, pt.n_real + 1, (4096,), dtype=torch.int32,
                         device=cuda_device)
    for w in (4, 16, 64, 256):
        got = tpg.range_gather_words(pt, offs, w)
        assert torch.equal(got, tref.range_gather_words_ref(pt, offs, w))


GATHER_NW = (1, 2, 3, 4, 5, 8, 16, 32, 64)  # the templates and two others
GATHER_ROWS = (0, 1, 1023, 4099)  # not multiples of the rows per thread


def _gather_offsets(f, hi, device, seed):
    """int32[f] offsets in [0, hi], the last ones at and just below hi."""
    g = torch.Generator().manual_seed(seed)
    offs = torch.randint(0, hi + 1, (f,), generator=g, dtype=torch.int32)
    k = min(f, 8)
    if k:
        offs[-k:] = torch.arange(hi - k + 1, hi + 1, dtype=torch.int32)
    return offs.to(device)


def _gather_masks(f, device):
    g = torch.Generator().manual_seed(f)
    return (None, (torch.rand(f, generator=g) < 0.5).to(device),
            torch.zeros(f, dtype=torch.bool, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("nw", GATHER_NW)
@pytest.mark.parametrize("alpha", ["dna", "protein_class", "byte"])
def test_cuda_range_gather_words_buckets(cuda_device, alpha, nw):
    """Every NW template (and nw outside them) at bits 2, 4 and 8: ragged
    row counts, offsets up to n_real, with and without the row mask."""
    a = ALPHABETS[alpha]
    spw = 32 // a.dense_bits
    w = nw * spw
    s = a.random_string(20_000, seed=nw)
    pt = tpk.pack_text(s, a, extra=w + 8, device=cuda_device)
    for f in GATHER_ROWS:
        offs = _gather_offsets(f, pt.n_real, cuda_device, seed=f + nw)
        for mask in _gather_masks(f, cuda_device):
            got = tpg.range_gather_words(pt, offs, w, mask=mask)
            want = tref.range_gather_words_ref(pt, offs, w, mask)
            assert got.shape == (f, nw) and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("nw", GATHER_NW)
@pytest.mark.parametrize("alpha", ["protein", "byte"])
def test_cuda_range_gather_pack_buckets(cuda_device, alpha, nw):
    """Every NW template (and nw outside them) on a byte string: ragged
    row counts, offsets to the end of the padding (the clamped tail),
    with and without the row mask."""
    s, sp = _byte_text(alpha, 20_000, cuda_device)
    for f in GATHER_ROWS:
        offs = _gather_offsets(f, sp.shape[0] - 1, cuda_device, seed=f + nw)
        for mask in _gather_masks(f, cuda_device):
            got = trg.range_gather_pack(sp, offs, 4 * nw, mask=mask)
            want = tref.range_gather_pack_ref(sp, offs, 4 * nw, mask)
            assert got.shape == (f, nw) and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("nw", [1, 2, 4, 64])
def test_cuda_gathers_large_launches(cuda_device, nw):
    """From 2^22 rows on, the gathers take several rows a thread (NW 1, 2)
    or four words a lane (NW >= 4): all three kernels, with and without
    the row mask, 2^22 + 5 rows."""
    f = (1 << 22) + 5
    a = ALPHABETS["dna"]
    pt = tpk.pack_text(a.random_string(300_000, seed=nw), a, extra=16 * nw + 8,
                       device=cuda_device)
    s, sp = _byte_text("protein", 300_000, cuda_device)
    mask = torch.rand(f, device=cuda_device) < 0.7
    offs_w = _gather_offsets(f, pt.n_real, cuda_device, seed=nw)
    offs_p = _gather_offsets(f, sp.shape[0] - 1, cuda_device, seed=nw)
    for m in (None, mask):
        assert torch.equal(tpg.range_gather_words(pt, offs_w, 16 * nw, mask=m),
                           tref.range_gather_words_ref(pt, offs_w, 16 * nw, m))
        assert torch.equal(trg.range_gather_pack(sp, offs_p, 4 * nw, mask=m),
                           tref.range_gather_pack_ref(sp, offs_p, 4 * nw, m))
        assert torch.equal(
            tpg.range_gather_packed(pt, offs_w, 4 * nw, mask=m),
            tref.range_gather_packed_ref(pt, offs_w, 4 * nw, m))


@pytest.mark.cuda
@pytest.mark.parametrize("side_stream", [False, True])
@pytest.mark.parametrize("kind", ["words", "pack"])
def test_cuda_gather_l2_window(cuda_device, kind, side_stream):
    """Under the measuring harness's persisting L2 window and without it
    the keys are the same; after the window the stream holds the window
    it held before and the device its persisting limit."""
    from repro_torch.launch.gather_bench import (
        l2_window_state,
        persisting_l2_window,
    )
    stream = torch.cuda.Stream() if side_stream else torch.cuda.current_stream()
    with torch.cuda.stream(stream):
        if kind == "words":
            a = ALPHABETS["dna"]
            text = tpk.pack_text(a.random_string(200_000, seed=3), a,
                                 extra=72, device=cuda_device)
            offs = _gather_offsets(65_537, text.n_real, cuda_device, seed=3)
            call = lambda m: tpg.range_gather_words(text, offs, 64, mask=m)
            want, buf = tref.range_gather_words_ref(text, offs, 64), text.words
        else:
            _, text = _byte_text("protein", 200_000, cuda_device)
            offs = _gather_offsets(65_537, text.shape[0] - 1, cuda_device,
                                   seed=3)
            call = lambda m: trg.range_gather_pack(text, offs, 4, mask=m)
            want, buf = tref.range_gather_pack_ref(text, offs, 4), text
        mask = offs % 3 != 0
        before = l2_window_state(stream)
        for windowed in (False, True, True, False):
            with (persisting_l2_window(buf) if windowed
                  else contextlib.nullcontext()):
                assert torch.equal(call(None), want)
                assert torch.equal(call(mask),
                                   torch.where(mask[:, None], want, 0))
            torch.cuda.synchronize()
            assert l2_window_state(stream) == before


@pytest.mark.cuda
def test_cuda_range_gather_words_tallies(cuda_device):
    """The rows and words that range_gather_words' launches gathered."""
    a = ALPHABETS["dna"]
    pt = tpk.pack_text(a.random_string(5_000, seed=2), a, extra=264,
                       device=cuda_device)
    offs = _gather_offsets(300, pt.n_real, cuda_device, seed=2)
    ops.reset_launch_counts()
    for w in (4, 64, 256):
        tpg.range_gather_words(pt, offs, w, mask=offs > 100)
    assert tpg.range_gather_words.launches == 3
    assert tpg.range_gather_words.rows == 3 * 300
    assert tpg.range_gather_words.words == 300 * (1 + 4 + 16)


@pytest.mark.cuda
def test_cuda_pattern_probe_words(cuda_device):
    rng = np.random.default_rng(3)
    dna = ALPHABETS["dna"]
    n, b, m = 5000, 400, 24
    s = dna.random_string(n, seed=n)
    pos = rng.integers(0, n + 1, size=b).astype(np.int32)
    pos[-20:] = rng.integers(n - m, n + 1, size=20)  # runs into the terminal
    lengths = rng.integers(1, m + 1, size=b).astype(np.int32)
    sym = rng.integers(0, 4, size=(b, m)).astype(np.int32)
    for i in range(0, b, 3):  # the suffix itself: verdict 0 unless it ends
        seg = s[pos[i]:min(pos[i] + m, n)]
        sym[i, :seg.size] = seg
    valid = np.arange(m)[None, :] < lengths[:, None]
    pt = tpk.pack_text(s, dna, extra=64, device=cuda_device)
    pat = tpk.pack_pattern_dense(torch.from_numpy(np.where(valid, sym, 0)),
                                 2, 4).to(cuda_device)
    mask = tpk.pack_dense(torch.from_numpy(
        np.where(valid, 3, 0).astype(np.int32)), 2).to(cuda_device)
    args = (pt, torch.from_numpy(pos).to(cuda_device), pat, mask,
            torch.from_numpy(lengths).to(cuda_device))
    assert torch.equal(tpg.pattern_probe_words(*args),
                       tref.pattern_probe_words_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("k,base", [(1, 5), (6, 5), (3, 21), (4, 16)])
def test_cuda_kmer_histogram(cuda_device, k, base):
    rng = np.random.default_rng(k)
    s = torch.from_numpy(rng.integers(0, base, size=100_000 + k).astype(np.uint8))
    s = s.to(cuda_device)
    got = tkmer.kmer_histogram(s, 100_000, k, base)
    assert torch.equal(got, tref.kmer_histogram_ref(s, 100_000, k, base))


KMER_BASES = (5, 21, 11, 27, 256)  # DNA, protein, PROTEIN_CLASS, english, byte


def _kmer_texts(base, k, device):
    """(name, string, n) cases: random, an unaligned start view, one window,
    ragged tails, a homopolymer and a planted 64-symbol motif."""
    rng = np.random.default_rng(base * 17 + k)
    rand = rng.integers(0, base, size=300_007 + k).astype(np.uint8)
    motif = rng.integers(0, base - 1, size=64).astype(np.uint8)
    planted = rand.copy()
    for p in range(0, 290_000, 1000):  # 6.4 % planted copies
        planted[p:p + 64] = motif
    cases = [("random", rand, 300_000), ("one window", rand, 1),
             ("homopolymer", np.full(70_000 + k, base - 1, np.uint8), 70_000),
             ("motif", planted, 300_000)]
    cases += [(f"ragged {n}", rand, n) for n in (15, 31, 33, 1023, 4097)]
    cases += [(f"offset {o}", rand[o:], 200_001) for o in (1, 3, 7, 13, 15)]
    return [(name, torch.from_numpy(sx).to(device), n)
            for name, sx, n in cases]


@pytest.mark.cuda
@pytest.mark.parametrize("base", KMER_BASES)
def test_cuda_kmer_histogram_layouts(cuda_device, base):
    """Every k with base**k <= 2^16 on the layout the plan gives it, on
    every text case; the layout that ran is the planned one."""
    _, smem = tkmer.device_limits(cuda_device)
    k = 1
    while base**k <= tkmer.MAX_BINS:
        for name, s, n in _kmer_texts(base, k, cuda_device):
            if name.startswith("offset"):  # a view starting off 16 bytes
                s = torch.empty(s.shape[0] + 16, dtype=torch.uint8,
                                device=cuda_device)[3:3 + s.shape[0]].copy_(s)
            got = tkmer.kmer_histogram(s, n, k, base)
            want = tref.kmer_histogram_ref(s, n, k, base)
            assert torch.equal(got, want), (base, k, name)
            assert int(got.sum()) == n
            assert tkmer.kmer_histogram.last_path == tkmer.plan(base**k,
                                                                smem).path
        k += 1


@pytest.mark.cuda
@pytest.mark.parametrize("nbins_k_base", [(125, 3, 5), (25, 2, 5), (441, 2, 21),
                                          (65536, 2, 256), (65536, 4, 16)])
def test_cuda_kmer_histogram_every_layout(cuda_device, nbins_k_base):
    """The same counts from every layout that holds the bins: warp copies,
    one histogram per block, and clusters of 2 and 4 blocks."""
    nbins, k, base = nbins_k_base
    _, smem = tkmer.device_limits(cuda_device)
    rng = np.random.default_rng(nbins)
    s = torch.from_numpy(rng.integers(0, base, size=500_011 + k)
                         .astype(np.uint8)).to(cuda_device)[1:]
    n = 500_000
    want = tref.kmer_histogram_ref(s, n, k, base)
    if nbins * 4 * 32 <= tkmer.WARP_COPY_BYTES:
        layouts = [tkmer.Plan("warp_copies", 32 * nbins * 4, 1, 0),
                   tkmer.Plan("block", nbins * 4, 1, 0)]
    else:
        layouts = [tkmer.Plan("cluster", 4 << (15 - c // 4), c, 15 - c // 4)
                   for c in (2, 4)]
    for layout in layouts:
        assert layout.smem <= smem
        got = tkmer.kmer_histogram(s, n, k, base, layout=layout)
        assert torch.equal(got, want), layout
        assert tkmer.kmer_histogram.last_path == layout.path


def _byte_text(name, n, device, extra=264):
    a = ALPHABETS[name]
    s = a.random_string(n, seed=n)
    return s, torch.from_numpy(a.pad_string(s, extra)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", ["protein", "byte"])
def test_cuda_range_gather_pack(cuda_device, alpha):
    s, sp = _byte_text(alpha, 50_000, cuda_device)
    offs = torch.randint(0, len(s), (4096,), dtype=torch.int32,
                         device=cuda_device)
    offs[-300:] = torch.arange(sp.shape[0] - 300, sp.shape[0],
                               dtype=torch.int32, device=cuda_device)
    ops.reset_launch_counts()
    for w in (4, 16, 64, 256):
        got = trg.range_gather_pack(sp, offs, w)
        assert torch.equal(got, tref.range_gather_pack_ref(sp, offs, w))
    # the tallies the redesign queue ranks the kernel by
    assert trg.range_gather_pack.launches == 4
    assert trg.range_gather_pack.rows == 4 * 4096
    assert trg.range_gather_pack.words == 4096 * (1 + 4 + 16 + 64)


@pytest.mark.cuda
def test_cuda_lcp_pairs(cuda_device):
    s, sp = _byte_text("byte", 20_000, cuda_device)
    offs = torch.randint(0, len(s), (3000,), dtype=torch.int32,
                         device=cuda_device)
    offs = torch.cat([offs, offs[:500]])  # identical rows
    for w in (4, 32, 256):
        keys = trg.range_gather_pack(sp, offs, w)
        order = torch.argsort(keys[:, 0].to(torch.int64) & 0xFFFFFFFF,
                              stable=True)
        keys = keys[order].contiguous()
        a, b = keys[:-1].contiguous(), keys[1:].contiguous()
        for g, x in zip(tlcp.lcp_pairs(a, b, w), tref.lcp_pairs_ref(a, b, w)):
            assert torch.equal(g, x)


def _probe_rows(s, name, b, m_pad, device, rng):
    a = ALPHABETS[name]
    n = len(s)
    pos = rng.integers(0, n, size=b).astype(np.int32)
    pos[-32:] = rng.integers(max(0, n - m_pad), n, size=32)
    lengths = rng.integers(1, m_pad + 1, size=b).astype(np.int32)
    sym = rng.integers(0, a.base, size=(b, m_pad)).astype(np.int32)
    sp = a.pad_string(s, m_pad)
    for i in range(0, b, 2):  # the suffix itself, terminal included
        sym[i] = sp[pos[i]:pos[i] + m_pad]
    pat, mask = _pack_query_batch(None, torch.from_numpy(sym).to(device),
                                  torch.from_numpy(lengths).to(device),
                                  word=False)
    return torch.from_numpy(pos).to(device), pat, mask


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", ["protein", "byte"])
def test_cuda_pattern_probe(cuda_device, alpha):
    rng = np.random.default_rng(5)
    s, sp = _byte_text(alpha, 30_000, cuda_device, extra=72)
    pos, pat, mask = _probe_rows(s, alpha, 512, 64, cuda_device, rng)
    got = tprobe.pattern_probe(sp, pos, pat, mask)
    assert torch.equal(got, tref.pattern_probe_ref(sp, pos, pat, mask))
    assert (got == 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", ["dna", "protein_class"])
def test_cuda_pattern_probe_packed(cuda_device, alpha):
    rng = np.random.default_rng(6)
    a = ALPHABETS[alpha]
    s = a.random_string(30_000, seed=2)
    pt = tpk.pack_text(s, a, extra=72, device=cuda_device)
    pos, pat, mask = _probe_rows(s, alpha, 512, 64, cuda_device, rng)
    got = tpg.pattern_probe_packed(pt, pos, pat, mask)
    assert torch.equal(got, tref.pattern_probe_packed_ref(pt, pos, pat, mask))
    assert (got == 0).any()


def _lcp_pairs(n, device, w_max=256):
    """Random pairs, pairs inside a planted copy (long shared prefixes),
    and pairs within w of the end."""
    rng = np.random.default_rng(n)
    pa = rng.integers(0, n + 1, size=4096)
    pb = rng.integers(0, n + 1, size=4096)
    pa[:1024] = 100 + rng.integers(0, 200, size=1024)
    pb[:1024] = pa[:1024] + n // 2 - 100
    pa[1024:1280] = rng.integers(n - w_max, n + 1, size=256)
    pb[1024:1280] = rng.integers(n - w_max, n + 1, size=256)
    t = lambda x: torch.from_numpy(x.astype(np.int32)).to(device)
    return t(pa), t(pb)


def _planted(a, n):
    s = a.random_string(n, seed=n)
    s[n // 2:n // 2 + 600] = s[100:700]
    return s


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", ["dna", "protein_class", "byte"])
def test_cuda_range_gather_packed(cuda_device, alpha):
    a = ALPHABETS[alpha]
    s = a.random_string(50_000, seed=3)
    pt = tpk.pack_text(s, a, extra=264, device=cuda_device)
    offs = torch.randint(0, pt.n_real + 1, (4096,), dtype=torch.int32,
                         device=cuda_device)
    offs[-300:] = torch.arange(pt.n_real - 299, pt.n_real + 1,
                               dtype=torch.int32, device=cuda_device)
    for w in (4, 16, 64, 256):
        got = tpg.range_gather_packed(pt, offs, w)
        assert torch.equal(got, tref.range_gather_packed_ref(pt, offs, w))


@pytest.mark.cuda
@pytest.mark.parametrize("nw", GATHER_NW)
@pytest.mark.parametrize("alpha", ["dna", "protein_class", "byte"])
def test_cuda_range_gather_packed_buckets(cuda_device, alpha, nw):
    """Every BITS x NW template (and nw outside them): ragged row counts,
    offsets at and past n_real (the terminal patched in), with and without
    the row mask; the tallies count every launch's rows and words."""
    a = ALPHABETS[alpha]
    s = a.random_string(20_000, seed=nw)
    pt = tpk.pack_text(s, a, extra=4 * nw + 8, device=cuda_device)
    ops.reset_launch_counts()
    for f in GATHER_ROWS:
        offs = _gather_offsets(f, pt.n_real + 40, cuda_device, seed=f + nw)
        for mask in _gather_masks(f, cuda_device):
            got = tpg.range_gather_packed(pt, offs, 4 * nw, mask=mask)
            want = tref.range_gather_packed_ref(pt, offs, 4 * nw, mask)
            assert got.shape == (f, nw) and torch.equal(got, want)
    rows = 3 * sum(GATHER_ROWS)
    assert tpg.range_gather_packed.launches == 3 * sum(map(bool, GATHER_ROWS))
    assert (tpg.range_gather_packed.rows,
            tpg.range_gather_packed.words) == (rows, rows * nw)


@pytest.mark.cuda
def test_cuda_range_gather_packed_past_2_31_words(cuda_device):
    """One launch of more than 2^31 output words (nw = 16, the byte leg's
    w = 64 step without compaction): the rows past 2^31 words against the
    plain version, a mixed mask on."""
    nw = 16
    first = (1 << 31) // nw
    f = first + (1 << 20)
    a = ALPHABETS["dna"]
    pt = tpk.pack_text(a.random_string(1 << 20, seed=9), a, extra=72,
                       device=cuda_device)
    offs = torch.randint(0, pt.n_real + 1, (f,), dtype=torch.int32,
                         device=cuda_device)
    mask = offs % 7 != 0
    out = tpg.range_gather_packed(pt, offs, 4 * nw, mask=mask)
    assert torch.equal(out[first:], tref.range_gather_packed_ref(
        pt, offs[first:], 4 * nw, mask[first:]))


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", ["dna", "protein_class", "byte"])
def test_cuda_suffix_lcp_words(cuda_device, alpha):
    a = ALPHABETS[alpha]
    s = _planted(a, 40_000)
    pt = tpk.pack_text(s, a, extra=264, device=cuda_device)
    pa, pb = _lcp_pairs(len(s) - 1, cuda_device)
    for w in (4, 64, 256):
        got = tpg.suffix_lcp_words(pt, pa, pb, w)
        assert torch.equal(got, tref.suffix_lcp_words_ref(pt, pa, pb, w))
        assert (got == w).any()


LCP_NW = (1, 2, 3, 4, 8, 16, 24, 32, 64)  # the buckets and two others


def _chained_pairs(n, b, chain, device, seed):
    """Distinct pairs in [0, n] chained as adjacent leaves are
    (``pos_a[i + 1] == pos_b[i]``) everywhere, in runs, or nowhere; the
    first 512 in the periodic head of :func:`_periodic` (long shared
    prefixes), the last rows at the text's end."""
    rng = np.random.default_rng(seed)
    pos = rng.permutation(n + 1)[:b + 1]
    pa, pb = pos[:-1].copy(), pos[1:].copy()
    pa[:512] = 1000 + 37 * np.arange(512)
    pb[:512] = pa[:512] + (74 if chain == "none" else 37)  # 74: no chain
    if chain == "partial":
        cut = rng.random(b) < 0.3
        cut[:512] = False
        pa[cut] = rng.integers(0, n + 1, size=int(cut.sum()))
    elif chain == "none":
        pa[512:] = rng.integers(0, n + 1, size=b - 512)
    pa[-6:] = [n - 1, n, n - 1, n, n - 2, 0]
    pb[-6:] = [n, n - 1, n - 2, 0, n - 1, n]
    keep = pa != pb
    t = lambda x: torch.from_numpy(x[keep].astype(np.int32)).to(device)
    return t(pa), t(pb)


def _periodic(a, n):
    """A random string whose first 30,000 symbols repeat a 37-symbol
    period."""
    s = a.random_string(n, seed=n)
    s[:30_000] = np.tile(s[:37], 30_000 // 37 + 1)[:30_000]
    return s


@pytest.mark.cuda
@pytest.mark.parametrize("chain", ["full", "partial", "none"])
@pytest.mark.parametrize("alpha", ["dna", "protein_class", "byte"])
def test_cuda_suffix_lcp_words_buckets(cuda_device, alpha, chain):
    """Every NW template (and widths outside them) at bits 2, 4 and 8, the
    node build's widths w = 64, 128, 256 and w = 4, on adjacency chains
    (the shuffled shared suffix) full, partial and absent, with pairs at
    the text's end; the tallies count the rows."""
    a = ALPHABETS[alpha]
    s = _periodic(a, 40_000)
    pt = tpk.pack_text(s, a, extra=2 * 512 + 8, device=cuda_device)
    spw = pt.syms_per_word
    pa, pb = _chained_pairs(len(s) - 1, 8192, chain, cuda_device,
                            seed=len(alpha) + len(chain))
    ws = sorted({4, 64, 128, 256} | {nw * spw for nw in LCP_NW})
    ops.reset_launch_counts()
    shared = float((pa[1:] == pb[:-1]).float().mean())
    assert {"full": shared > 0.99, "partial": 0.5 < shared < 0.95,
            "none": shared < 0.01}[chain], shared
    for w in ws:
        got = tpg.suffix_lcp_words(pt, pa, pb, w)
        assert torch.equal(got, tref.suffix_lcp_words_ref(pt, pa, pb, w)), w
        assert (got[:512] == w).all()
    assert tpg.suffix_lcp_words.rows == len(ws) * pa.shape[0]
    assert tpg.suffix_lcp_words.words_read >= tpg.suffix_lcp_words.rows * 4


@pytest.mark.cuda
def test_cuda_suffix_lcp_words_unaligned_and_tail(cuda_device):
    """Words that do not start on 16 bytes (scalar reads) and reads that
    reach the array's last words equal the plain version."""
    a = ALPHABETS["dna"]
    s = _planted(a, 30_000)
    pt = tpk.pack_text(s, a, extra=264, device=cuda_device)
    words = torch.empty(pt.words.shape[0] + 1, dtype=torch.int32,
                        device=cuda_device)[1:].copy_(pt.words)
    shifted = dataclasses.replace(pt, words=words)
    pa, pb = _lcp_pairs(len(s) - 1, cuda_device)
    for text in (pt, shifted):
        for w in (4, 64, 256):
            got = tpg.suffix_lcp_words(text, pa, pb, w)
            assert torch.equal(got, tref.suffix_lcp_words_ref(text, pa, pb, w))


@pytest.mark.cuda
@pytest.mark.parametrize("alpha,extra", [("protein", 264), ("byte", 8)])
def test_cuda_suffix_lcp_pairs(cuda_device, alpha, extra):
    """Reads past a short padding clamp to the last symbol alike."""
    a = ALPHABETS[alpha]
    s = _planted(a, 40_000)
    sp = torch.from_numpy(a.pad_string(s, extra)).to(cuda_device)
    pa, pb = _lcp_pairs(len(s) - 1, cuda_device)
    for w in (4, 64, 256):
        got = tslcp.suffix_lcp_pairs(sp, pa, pb, w)
        assert torch.equal(got, tref.suffix_lcp_pairs_ref(sp, pa, pb, w))
        assert (got == w).any()


SLCP_W = (4, 8, 12, 16, 20, 32, 64, 128, 256)  # every NW bucket and two others


@pytest.mark.cuda
@pytest.mark.parametrize("chain", ["full", "partial", "none"])
@pytest.mark.parametrize("alpha,extra", [("protein", 264), ("byte", 8)])
def test_cuda_suffix_lcp_pairs_buckets(cuda_device, alpha, extra, chain):
    """Every NW bucket (and widths outside them) on adjacency chains full
    (the node build's adjacent leaves), partial, and absent (shuffled and
    boundary pairs), byte codes >= 128, and with the short padding chunks
    that cross n_s (the clamped tail)."""
    a = ALPHABETS[alpha]
    s = _periodic(a, 40_000)
    sp = torch.from_numpy(a.pad_string(s, extra)).to(cuda_device)
    pa, pb = _chained_pairs(len(s) - 1, 8192, chain, cuda_device,
                            seed=len(alpha) + len(chain) + extra)
    shared = float((pa[1:] == pb[:-1]).float().mean())
    assert {"full": shared > 0.99, "partial": 0.5 < shared < 0.95,
            "none": shared < 0.01}[chain], shared
    if alpha == "byte":
        assert (sp >= 128).any()
    for w in SLCP_W:
        got = tslcp.suffix_lcp_pairs(sp, pa, pb, w)
        assert torch.equal(got, tref.suffix_lcp_pairs_ref(sp, pa, pb, w)), w
        assert (got[:512] == w).all()


@pytest.mark.cuda
def test_cuda_suffix_lcp_pairs_refuses_misaligned_view(cuda_device):
    """The 16-byte reads need a 16-byte aligned string: an offset view is
    refused, the same string uploaded fresh is read."""
    a = ALPHABETS["protein"]
    s = _planted(a, 5_000)
    sp = torch.from_numpy(a.pad_string(s, 264)).to(cuda_device)
    view = torch.empty(sp.shape[0] + 4, dtype=torch.uint8,
                       device=cuda_device)[4:]
    view.copy_(sp)
    pa, pb = _lcp_pairs(len(s) - 1, cuda_device)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="16 bytes"):
        tslcp.suffix_lcp_pairs(view, pa, pb, 64)
    assert tslcp.suffix_lcp_pairs.launches == 0
    assert torch.equal(tslcp.suffix_lcp_pairs(sp, pa, pb, 64),
                       tref.suffix_lcp_pairs_ref(sp, pa, pb, 64))


@pytest.mark.cuda
def test_cuda_launches_are_counted(cuda_device):
    ops.reset_launch_counts()
    s = torch.zeros(64, dtype=torch.uint8, device=cuda_device)
    ops.kmer_histogram(s, 60, 2, 5)
    assert ops.launch_counts()["kmer_histogram"] == 1


FUSED_CASES = [("dna", 8, 32), ("dna", 16, 4), ("protein_class", 8, 16),
               ("byte", 12, 12)]


def _fused_rows(name, m, device, rng, b=600, n=20_000):
    """Probe rows over a dense text: planted suffixes (terminal-tail ones
    included) and random rows, as word and byte-key pattern batches."""
    a = ALPHABETS[name]
    s = a.random_string(n, seed=n + m)
    pt = tpk.pack_text(s, a, extra=96, device=device)
    m_pad = -(-m // 4) * 4
    pos = rng.integers(0, n + 1, size=b).astype(np.int32)
    pos[-40:] = rng.integers(n - m_pad, n + 1, size=40)
    lengths = rng.integers(1, m + 1, size=b).astype(np.int32)
    sym = rng.integers(0, len(a.symbols), size=(b, m_pad)).astype(np.int32)
    sp = a.pad_string(s, m_pad)
    for i in range(0, b, 2):
        sym[i] = sp[pos[i]:pos[i] + m_pad]
    sym_t = torch.from_numpy(sym).to(device)
    len_t = torch.from_numpy(lengths).to(device)
    word = _pack_query_batch(pt, sym_t, len_t)
    byte = _pack_query_batch(None, sym_t, len_t, word=False)
    return pt, torch.from_numpy(pos).to(device), len_t, word, byte


@pytest.mark.cuda
@pytest.mark.parametrize("alpha,m,fetch", FUSED_CASES)
def test_cuda_probe_gather_words(cuda_device, alpha, m, fetch):
    """Equal to its plain version and to the two launches it fuses."""
    rng = np.random.default_rng(m + fetch)
    pt, pos, lengths, (pat, mask), _ = _fused_rows(alpha, m, cuda_device, rng)
    ops.reset_launch_counts()
    cmp, win = tfused.probe_gather_words(pt, pos, pat, mask, lengths, fetch)
    assert ops.launch_counts()["probe_gather_words"] == 1
    want = tref.probe_gather_words_ref(pt, pos, pat, mask, lengths,
                                       fetch=fetch)
    assert torch.equal(cmp, want[0]) and torch.equal(win, want[1])
    assert torch.equal(cmp, tpg.pattern_probe_words(pt, pos, pat, mask,
                                                    lengths))
    assert torch.equal(win, tpg.range_gather_words(pt, pos, fetch))
    assert (cmp == 0).any() and (cmp != 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("alpha,m,fetch", FUSED_CASES)
def test_cuda_probe_gather_packed(cuda_device, alpha, m, fetch):
    rng = np.random.default_rng(2 * m + fetch)
    pt, pos, _, _, (pat, mask) = _fused_rows(alpha, m, cuda_device, rng)
    cmp, keys = tfused.probe_gather_packed(pt, pos, pat, mask, fetch)
    want = tref.probe_gather_packed_ref(pt, pos, pat, mask, fetch=fetch)
    assert torch.equal(cmp, want[0]) and torch.equal(keys, want[1])
    assert torch.equal(cmp, tpg.pattern_probe_packed(pt, pos, pat, mask))
    assert torch.equal(keys, tpg.range_gather_packed(pt, pos, fetch))
    assert (cmp == 0).any() and (cmp != 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("fetch", [0, 16])
def test_cuda_async_server_equals_sync(cuda_device, fetch):
    """The pipelined, cached server on the card returns what the
    synchronous one returns, request for request."""
    from repro_torch.core.api import EraConfig, EraIndexer
    from repro_torch.launch.serving import (
        ServeConfig,
        make_hot_workload,
        run_closed_loop,
    )
    a = ALPHABETS["dna"]
    s = a.random_string(20_000, seed=11)
    dev = EraIndexer(a, EraConfig(memory_bytes=1 << 16, build_impl="none"),
                     device=cuda_device).build_device(s, max_pattern_len=64)
    pats = make_hot_workload(s, np.random.default_rng(3), n_requests=2000,
                             hot_pool=16, hot_frac=0.7, min_len=2,
                             max_len=18)
    sync, _ = run_closed_loop(dev, pats, ServeConfig(
        pipeline=False, cache_size=0, fetch=fetch))
    for kw in (dict(pipeline=True, cache_size=0, max_batch=64),
               dict(pipeline=True, cache_size=256, max_batch=64)):
        got, stats = run_closed_loop(dev, pats, ServeConfig(fetch=fetch, **kw))
        assert stats["batches"] > 1
        for (p1, w1), (p2, w2) in zip(got, sync):
            np.testing.assert_array_equal(p1, p2)
            if fetch:
                np.testing.assert_array_equal(w1, w2)
    ranges = dev.find_batch(pats)
    for (p1, _), want in zip(sync, ranges):
        np.testing.assert_array_equal(p1, want)


# flash_attention against its plain version on the card.  Tolerances: in
# float32 the JAX test's own (rtol 1e-5, atol 2e-5: the online softmax sums
# in another order), matrix products in full float32 (TF32 off, stated and
# set here); in bfloat16 one bf16 ulp of each output (rtol 2^-7, since
# ulp(x) <= 2^-7 |x| and both sides round one float32 result) plus the
# float32 atol 2e-5 for outputs near 0.
FLASH_CASES = [  # (B, Sq, Sk, H, KV, D)
    (2, 128, 128, 4, 2, 32), (1, 256, 256, 8, 8, 64), (2, 128, 128, 4, 1, 32),
    (1, 64, 64, 2, 2, 16), (2, 96, 96, 4, 4, 32), (1, 1000, 1000, 4, 2, 128),
    (2, 77, 200, 4, 2, 48), (2, 200, 77, 2, 1, 256), (1, 300, 300, 8, 2, 256),
    (1, 1, 33, 4, 4, 16),
    # the edges of the bf16 wgmma + TMA kernel's tiles (64 rows, 64 keys,
    # 64 columns of D, two warpgroups on a GQA pair or on one head)
    (1, 192, 192, 4, 4, 128),  # GQA group 1: two row tiles of one head
    (2, 160, 160, 8, 2, 64),   # group 4
    (1, 256, 256, 8, 1, 128),  # group 8
    (2, 100, 100, 4, 2, 16),   # D 16
    (1, 130, 130, 4, 2, 48),   # D 48
    (2, 150, 150, 4, 2, 80),   # D 80
    (2, 1, 300, 8, 2, 128),    # Sq 1
    (2, 50, 40, 4, 2, 64),     # Sk < 64
    (1, 65, 300, 4, 2, 128),   # Sq < Sk
    (1, 300, 65, 4, 2, 128),   # Sq > Sk
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("b,sq,sk,h,kv,d", FLASH_CASES)
def test_cuda_flash_attention(cuda_device, b, sq, sk, h, kv, d, causal, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(sq * 7 + d)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device
                           ).to(dtype)
               for shape in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d)))
    launches = tflash.flash_attention.launches
    got = tflash.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tflash.flash_attention.launches == launches + 1
    want = tref.flash_attention_ref(q, k, v, causal)
    assert got.dtype == dtype and got.shape == (b, sq, h, d)
    rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", [
    (2, 300, 300, 8, 2, 128, True), (1, 130, 200, 4, 4, 64, False),
    (1, 200, 200, 4, 1, 256, True)])
def test_cuda_flash_attention_moving_max(cuda_device, b, sq, sk, h, kv, d,
                                         causal):
    """bf16 with q scaled x8: scores of ~+-90, so the running max moves a
    long way between key tiles and the rescaling of the accumulator is
    exercised; the same bf16 tolerance as above."""
    gen = torch.Generator(device=cuda_device).manual_seed(sq + d)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device)
               for shape in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d)))
    q, k, v = (q * 8).bfloat16(), k.bfloat16(), v.bfloat16()
    got = tflash.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = tref.flash_attention_ref(q, k, v, causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=2e-5)


@pytest.mark.cuda
def test_cuda_flash_attention_routes(cuda_device):
    """bf16 reaches the wgmma + TMA kernel and float32 the CUDA-core one;
    both count as launches of ``flash_attention``."""
    q = torch.randn((1, 70, 4, 64), device=cuda_device)
    k = torch.randn((1, 70, 2, 64), device=cuda_device)
    for dtype, design in ((torch.bfloat16, "wgmma_tma"),
                          (torch.float32, "cuda_cores")):
        launches = tflash.flash_attention.launches
        tflash.flash_attention(q.to(dtype), k.to(dtype), k.to(dtype))
        torch.cuda.synchronize()
        assert tflash.flash_attention.route == design
        assert tflash.flash_attention.launches == launches + 1
    # a bf16 view at an offset that is not 16-byte aligned is copied for
    # the kernel's TMA loads and gives the same result
    flat = torch.randn(70 * 4 * 64 + 1, device=cuda_device).bfloat16()
    q_odd = flat[1:].view(1, 70, 4, 64)
    got = tflash.flash_attention(q_odd, k.bfloat16(), k.bfloat16())
    want = tflash.flash_attention(q_odd.clone(), k.bfloat16(), k.bfloat16())
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_smoke_prefill_counts_flash(cuda_device):
    """A smoke-width qwen3-1.7b prefill on the card launches the kernel once
    per layer and its logits equal the CPU run's (plain versions) to the
    float32 tolerance of tests/test_torch_models.py; the decode launches
    none."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config(get_config("qwen3-1.7b"))
    params = T.init_params(0, cfg, torch.float32, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(2, 40), dtype=np.int32))
    want, _ = T.forward_prefill(params, {"tokens": tokens}, cfg,
                                T.init_cache(cfg, 2, 48, torch.float32, "cpu"))
    dev_params = _to(params, cuda_device)
    cache = T.init_cache(cfg, 2, 48, torch.float32, cuda_device)
    ops.reset_launch_counts()
    got, cache = T.forward_prefill(dev_params, {"tokens": tokens.to(cuda_device)},
                                   cfg, cache)
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4,
                               atol=2e-5 * float(want.abs().max()))
    T.forward_decode(dev_params, tokens[:, :1].to(cuda_device), cfg, cache)
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return {k: _to(v, device) for k, v in tree.items()}


# ---- the search kernels: one launch per search --------------------------

# m_pad per search kind, so that NW sits at and past the register-template
# edges (2, 4, 8, 16) and on the shared-memory route above 16: DNA packs
# 16 symbols a word (NW 1 2 3 4 8 16 17 32), byte keys 4 (NW 1 2 3 4 8 16
# 17 128 — max_pattern_len 512)
SEARCH_M_PAD = {"words": (16, 32, 48, 64, 128, 256, 272, 512),
                "bytes": (4, 8, 12, 16, 32, 64, 68, 512)}


@functools.lru_cache(maxsize=None)
def _search_index(kind):
    """A card index: DNA on dense words, protein on the byte string, each
    with a planted repeat (long matches)."""
    from repro_torch.core.api import EraConfig, EraIndexer
    a = ALPHABETS["dna" if kind == "words" else "protein"]
    s = a.random_string(60_000, seed=9)
    s[30_000:30_600] = s[1_000:1_600]
    dev = EraIndexer(a, EraConfig(memory_bytes=1 << 16),
                     device="cuda").build_device(s)
    return s, a, dev


def _search_rows(kind, m_pad, window, rng, b=700):
    """Pattern rows of lengths 1..m_pad (planted substrings, patterns that
    end at the text's terminal tail, random codes) and their windows:
    routed, unrouted ([0, total): every trip runs) or empty."""
    s, a, dev = _search_index(kind)
    n = len(s) - 1
    pats = []
    for i in range(b):
        m = int(rng.integers(1, m_pad + 1))
        if i % 3 == 0:
            p = int(rng.integers(0, n))
            pats.append(s[p:p + m])
        elif i % 3 == 1:
            tail = s[n - min(m, n):n]
            if kind == "bytes" and i % 2:  # into the terminal
                tail = np.append(tail[1:], a.terminal_code).astype(np.uint8)
            pats.append(tail if tail.size else s[:1])
        else:
            pats.append(rng.integers(0, len(a.symbols), m).astype(np.uint8))
    padded, lengths, route = dev.pad_batch(pats, m_pad=m_pad)
    t = lambda x: torch.from_numpy(x).cuda()
    len_t = t(lengths)
    pat, mask = _pack_query_batch(dev.s_text, t(padded), len_t,
                                  kind == "words")
    lo0, hi0 = _route_window(dev.win_lo, dev.win_hi, dev.pows, dev.spans,
                             len_t, t(route), dev.k_route)
    if window == "unrouted":
        lo0, hi0 = torch.zeros_like(lo0), torch.full_like(hi0, dev.n_leaves)
    elif window == "empty":
        lo0 = torch.randint(0, dev.n_leaves + 1, lo0.shape, device="cuda",
                            dtype=torch.int32)
        hi0 = lo0.clone()
    return dev, pat, mask, len_t, lo0.contiguous(), hi0.contiguous()


def _searches(kind, dev, pat, mask, lengths, lim_p, lo0, hi0, bounds):
    """(kernel, loop with the plain probe, loop of single-step kernels)."""
    kw = dict(n_iter=dev.n_iter, bounds=bounds)
    if kind == "words":
        rows = (dev.s_text, dev.ell, pat, mask, lengths, lim_p, lo0, hi0)
        return (ops.search_bounds_words(*rows, **kw),
                tsearch.search_loop(tref.pattern_probe_words_ref, *rows, **kw),
                tsearch.search_loop(ops.pattern_probe_words, *rows, **kw))
    rows = (dev.s_text, dev.ell, pat, mask)
    return (ops.search_bounds_bytes(*rows, lo0, hi0, **kw),
            tsearch.search_loop(tref.pattern_probe_ref, *rows, None, None,
                                lo0, hi0, **kw),
            tsearch.search_loop(ops.pattern_probe, *rows, None, None, lo0,
                                hi0, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("window", ["routed", "unrouted", "empty"])
@pytest.mark.parametrize("kind,m_pad", [(k, m) for k in SEARCH_M_PAD
                                        for m in SEARCH_M_PAD[k]])
def test_cuda_search_bounds(cuda_device, kind, m_pad, window):
    """Each search kernel equals the loop with the plain probes and the
    loop of single-step kernels, both bounds and the lower bound alone
    (words: also with a pattern limit below the compare length), in one
    launch."""
    rng = np.random.default_rng(m_pad)
    dev, pat, mask, lengths, lo0, hi0 = _search_rows(kind, m_pad, window,
                                                     rng)
    lim_cut = torch.clamp(lengths - torch.randint_like(lengths, 0, 8), min=0)
    for bounds, lim_p in ((2, None), (1, None), (1, lim_cut)):
        if lim_p is not None and kind == "bytes":
            continue
        ops.reset_launch_counts()
        got, plain, steps = _searches(kind, dev, pat, mask, lengths, lim_p,
                                      lo0, hi0, bounds)
        assert ops.launch_counts()[f"search_bounds_{kind}"] == 1
        assert got.shape == (bounds, pat.shape[0])
        assert torch.equal(got, plain) and torch.equal(got, steps)
        if window == "empty":
            assert torch.equal(got[0], lo0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["words", "bytes"])
@pytest.mark.parametrize("b", [0, 1, 1 << 19, 1 << 20])
def test_cuda_search_bounds_batch_sizes(cuda_device, kind, b):
    """B = 0 and B = 1, and 2^20 and 2^21 rows (both bounds), where each
    thread of the capped grid strides over several rows."""
    rng = np.random.default_rng(b)
    dev, pat, mask, lengths, lo0, hi0 = _search_rows(kind, 24, "routed", rng)
    idx = torch.from_numpy(rng.integers(0, pat.shape[0], b)).cuda()
    got, plain, steps = _searches(kind, dev, pat[idx].contiguous(),
                                  mask[idx].contiguous(), lengths[idx], None,
                                  lo0[idx], hi0[idx], 2)
    assert got.shape == (2, b)
    assert torch.equal(got, plain) and torch.equal(got, steps)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["words", "bytes"])
def test_cuda_find_batch_is_one_search_launch(cuda_device, kind):
    """A search batch launches its search kernel once and no single-step
    probe; the ranges hold exactly each pattern's occurrences."""
    s, a, dev = _search_index(kind)
    rng = np.random.default_rng(4)
    pats = [s[p:p + m] for p, m in zip(rng.integers(0, len(s) - 30, 40),
                                       rng.integers(1, 24, 40))]
    ops.reset_launch_counts()
    found = dev.find_batch(pats)
    counts = ops.launch_counts()
    assert counts[f"search_bounds_{kind}"] == 1
    assert counts["pattern_probe_words"] == counts["pattern_probe"] == 0
    for p, got in zip(pats, found):
        win = np.lib.stride_tricks.sliding_window_view(s[:-1], len(p))
        assert got.tolist() == np.nonzero((win == p).all(1))[0].tolist()


# ---- the fused find-and-fetch: one launch per batch ----------------------

def _fetches(kind, dev, pat, mask, lengths, lo0, hi0, fetch):
    """(fused kernel, its plain version on the card, the ported kernels it
    fuses launched one after the other), each (start, count, window,
    verified)."""
    word = kind == "words"
    args = (dev.s_text, dev.ell, pat, mask)
    kw = dict(n_iter=dev.n_iter, fetch=fetch)
    if word:
        fused = tsearch.search_fetch_words(*args, lengths, lo0, hi0, **kw)
    else:
        fused = tsearch.search_fetch_bytes(*args, lo0, hi0, **kw)
    comp = functools.partial(tsearch.fetch_composition, *args,
                             lengths if word else None, lo0, hi0, word=word,
                             **kw)
    return fused, comp(), comp(plain=False)


def _assert_fetch_equal(got, *wants):
    for want in wants:
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("window,fetch", [("routed", 32), ("routed", 4),
                                          ("unrouted", 36), ("empty", 64)])
@pytest.mark.parametrize("kind,m_pad", [(k, m) for k in SEARCH_M_PAD
                                        for m in SEARCH_M_PAD[k]])
def test_cuda_search_fetch(cuda_device, kind, m_pad, window, fetch):
    """Each fused find-and-fetch kernel equals its plain version and the
    search + epilogue kernels it fuses, in one launch: NW at and past the
    register templates and on the shared-memory route, fetch narrower and
    wider than the pattern, windows that run past the text's end, rows
    that match nothing and empty windows."""
    rng = np.random.default_rng(m_pad + fetch)
    dev, pat, mask, lengths, lo0, hi0 = _search_rows(kind, m_pad, window,
                                                     rng)
    ops.reset_launch_counts()
    got, plain, kernels = _fetches(kind, dev, pat, mask, lengths, lo0, hi0,
                                   fetch)
    assert ops.launch_counts()[f"search_fetch_{kind}"] == 1
    assert got[2].shape == (pat.shape[0], fetch)
    _assert_fetch_equal(got, plain, kernels)
    if window == "empty":
        assert (got[1] == 0).all() and (got[2] == -1).all()
    else:
        assert (got[1] > 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["words", "bytes"])
@pytest.mark.parametrize("b", [0, 1, 33, 1 << 20])
def test_cuda_search_fetch_batch_sizes(cuda_device, kind, b):
    """B = 0, 1 and 33 (a warp of lane pairs half filled), and 2^20
    patterns (2^21 lanes: each thread of the capped grid strides)."""
    rng = np.random.default_rng(b)
    dev, pat, mask, lengths, lo0, hi0 = _search_rows(kind, 24, "routed", rng)
    idx = torch.from_numpy(rng.integers(0, pat.shape[0], b)).cuda()
    got, plain, kernels = _fetches(
        kind, dev, pat[idx].contiguous(), mask[idx].contiguous(),
        lengths[idx], lo0[idx], hi0[idx], 32)
    assert got[2].shape == (b, 32)
    _assert_fetch_equal(got, plain, kernels)


@functools.lru_cache(maxsize=None)
def _dense_index(alpha):
    """A dense card index of 4-bit (protein_class) or 8-bit (protein,
    packed dense) words."""
    from repro_torch.core.api import EraConfig, EraIndexer
    a = ALPHABETS[alpha]
    s = a.random_string(30_000, seed=3)
    s[20_000:20_300] = s[500:800]
    dev = EraIndexer(a, EraConfig(memory_bytes=1 << 16), device="cuda"
                     ).build_device(s, packing="dense")
    return s, a, dev


@pytest.mark.cuda
@pytest.mark.parametrize("fetch", [8, 36])
@pytest.mark.parametrize("alpha", ["protein_class", "protein"])
def test_cuda_search_fetch_word_widths(cuda_device, alpha, fetch):
    """The word kernel on 4- and 8-bit dense words (decoded from 8 and 4
    fields a word), patterns at the text's end included."""
    s, a, dev = _dense_index(alpha)
    assert dev.packed
    rng = np.random.default_rng(7)
    n = len(s) - 1
    pats = [s[p:p + m] for p, m in zip(rng.integers(0, n - 40, 300),
                                       rng.integers(1, 40, 300))]
    pats += [s[n - k:n] for k in range(1, 40)]
    pats += [rng.integers(0, len(a.symbols), 9).astype(np.uint8)
             for _ in range(40)]
    padded, lengths, route = dev.pad_batch(pats)
    t = lambda x: torch.from_numpy(x).cuda()
    len_t = t(lengths)
    pat, mask = _pack_query_batch(dev.s_text, t(padded), len_t)
    lo0, hi0 = _route_window(dev.win_lo, dev.win_hi, dev.pows, dev.spans,
                             len_t, t(route), dev.k_route)
    got, plain, kernels = _fetches("words", dev, pat, mask, len_t, lo0, hi0,
                                   fetch)
    _assert_fetch_equal(got, plain, kernels)
    assert (got[1] > 0).any() and (got[1] == 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["words", "bytes"])
def test_cuda_find_fetch_is_one_launch(cuda_device, kind):
    """A find-and-fetch batch launches its fused kernel once and none of
    the search and epilogue kernels it replaces; each window is the text
    at the pattern's first match, -1 where it does not occur."""
    s, a, dev = _search_index(kind)
    rng = np.random.default_rng(6)
    n = len(s) - 1
    pats = [s[p:p + m] for p, m in zip(rng.integers(0, n - 30, 40),
                                       rng.integers(1, 24, 40))]
    pats += [s[n - 5:n], rng.integers(0, len(a.symbols), 12).astype(np.uint8)]
    ops.reset_launch_counts()
    start, count, win, verified = dev.find_fetch_ranges(
        *dev.pad_batch(pats), fetch=32)
    counts = ops.launch_counts()
    assert counts[f"search_fetch_{kind}"] == 1
    assert sum(counts.values()) == 1
    s_dev = torch.from_numpy(s).cuda()
    pos0 = dev.ell[torch.clamp(start, 0, dev.n_leaves - 1)].long()
    idx = torch.clamp(pos0[:, None] + torch.arange(32, device="cuda"),
                      max=n)
    has = count > 0
    assert torch.equal(win, torch.where(has[:, None], s_dev[idx].int(), -1))
    assert bool((verified[has] == 0).all()) and bool((~has).any())

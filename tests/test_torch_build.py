"""PyTorch port vs the JAX package: sparse-table RMQ and the node build.

``core/rmq.py`` (sparse table, range min/argmin, previous-smaller
search) and ``core/build.py`` (the sequential and the batched parallel
Cartesian-tree builders, pad-width buckets, text-derived divergence rows,
row extraction) on random rows and on the DNA, protein and byte strings,
with the text reads under both ``REPRO_WORD_COMPARE`` legs.  The port
runs on the CPU.  Tolerance: exact — every quantity is an integer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build as jb
from repro.core import packing as jpk
from repro.core import rmq as jrmq
from repro.core.alphabet import ALPHABETS as J_ALPHABETS
from repro_torch.core import build as tb
from repro_torch.core import packing as tpk
from repro_torch.core import rmq as trmq
from repro_torch.core.alphabet import ALPHABETS


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("n", [1, 2, 7, 64, 300])
def test_rmq_equal(n):
    rng = np.random.default_rng(n)
    h = rng.integers(0, 9, size=n).astype(np.int32)
    h[0] = -1  # the sentinel wall prev_less needs
    levels = jrmq.log2_ceil(n) + 2
    jvals, jargs = jrmq.sparse_table(jnp.asarray(h), levels)
    tvals, targs = trmq.sparse_table(torch.from_numpy(h), levels,
                                     with_args=True)
    np.testing.assert_array_equal(tvals.numpy(), np.stack(jvals))
    np.testing.assert_array_equal(targs.numpy(), np.stack(jargs))
    lo = rng.integers(0, n, size=50)
    hi = np.maximum(lo, rng.integers(0, n, size=50))
    jl, jh = jnp.asarray(lo, jnp.int32), jnp.asarray(hi, jnp.int32)
    tl, th = torch.from_numpy(lo), torch.from_numpy(hi)
    np.testing.assert_array_equal(trmq.range_min(tvals, tl, th).numpy(),
                                  np.asarray(jrmq.range_min(jvals, jl, jh)))
    np.testing.assert_array_equal(
        trmq.range_argmin(tvals, targs, tl, th).numpy(),
        np.asarray(jrmq.range_argmin(jvals, jargs, jl, jh)))
    target = rng.integers(0, 10, size=50).astype(np.int32)
    np.testing.assert_array_equal(
        trmq.prev_less(tvals, th, torch.from_numpy(target)).numpy(),
        np.asarray(jrmq.prev_less(jvals, jh, jnp.asarray(target))))
    assert trmq.log2_ceil(n) == jrmq.log2_ceil(n)


@pytest.mark.parametrize("f", [1, 3, 40, 129])
def test_build_parallel_equal(f):
    """Unpadded rows, where the last event can be canonical (the id JAX
    also uses as its scatter dump slot)."""
    rng = np.random.default_rng(f)
    for trial in range(2):
        ell = rng.permutation(500)[:f].astype(np.int32)
        b_off = rng.integers(1, 6, size=f).astype(np.int32)
        want = jb.nodes_to_host(jb.build_parallel(jnp.asarray(ell),
                                                  jnp.asarray(b_off), 500))
        got = tb.nodes_to_host(tb.build_parallel(torch.from_numpy(ell),
                                                 torch.from_numpy(b_off), 500))
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert tb.nodes_to_intervals(got) == jb.nodes_to_intervals(want)


@pytest.mark.parametrize("byte_budget", [1 << 40, 1], ids=["one", "chunks"])
def test_build_parallel_batch_equal(byte_budget):
    """Depth-0 padded rows; the row chunks of a tiny byte budget give the
    same node arrays as one batch."""
    rng = np.random.default_rng(11)
    p, f_pad, n_total = 7, 37, 800
    ell = np.full((p, f_pad), n_total, np.int32)
    boff = np.zeros((p, f_pad), np.int32)
    for r in range(p):
        f = int(rng.integers(1, f_pad - tb.PAD_MIN + 1))
        ell[r, :f] = rng.permutation(n_total)[:f]
        boff[r, :f] = rng.integers(1, 7, size=f)
    want = jb.build_parallel_batch(jnp.asarray(ell), jnp.asarray(boff),
                                   n_total)
    got = tb.build_parallel_batch(torch.from_numpy(ell), torch.from_numpy(boff),
                                  n_total, byte_budget=byte_budget)
    for name in ("parent", "depth", "witness", "n_nodes"):
        np.testing.assert_array_equal(_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)))
    assert tb.rows_per_chunk(f_pad, 1) == 1
    assert tb.rows_per_chunk(f_pad, 1 << 40) >= p


@pytest.mark.parametrize("max_buckets", [None, 1, 2, 3])
def test_bucket_pad_widths_equal(max_buckets):
    rng = np.random.default_rng(3)
    freqs = np.concatenate([rng.integers(1, 20, 60), rng.integers(100, 900, 9),
                            [5000, 7]])
    want = jb.bucket_pad_widths(freqs, max_buckets)
    got = tb.bucket_pad_widths(freqs, max_buckets)
    assert [w for w, _ in got] == [w for w, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert tb.pad_width(10) == jb.pad_width(10)
    assert tb.bucket_pad_widths([]) == []


def _text_pairs(alpha_name, n, seed):
    """A dataset-like string with a planted repeat, and adjacent-looking
    pairs: inside the repeat (long LCPs), random, and near the end."""
    a = J_ALPHABETS[alpha_name]
    s = a.random_string(n, seed=seed)
    s[n // 2:n // 2 + 300] = s[20:320]  # LCPs up to ~300 > w_cap
    rng = np.random.default_rng(seed)
    pa = np.concatenate([np.arange(20, 60), rng.integers(0, n, 40),
                         np.arange(n - 12, n + 1)])
    pb = np.concatenate([np.arange(20, 60) + n // 2 - 20,
                         rng.integers(0, n, 40), np.arange(n - 24, n - 11)])
    keep = pa != pb
    return a, s, pa[keep], pb[keep]


@pytest.mark.parametrize("alpha,packing,leg", [
    ("dna", "dense", "word"), ("dna", "dense", "byte"),
    ("protein_class", "dense", "word"), ("protein", "bytes", "word"),
    ("byte", "dense", "byte"),
])
def test_lcp_from_text_equal(monkeypatch, alpha, packing, leg):
    """The doubling LCP recomputed from the text (the build's padding,
    2 * w_max + 8) equals JAX's, saturated pairs included."""
    monkeypatch.setenv("REPRO_WORD_COMPARE", leg)
    a, s, pa, pb = _text_pairs(alpha, 1000, seed=len(alpha))
    extra = 2 * 256 + 8
    if packing == "dense":
        jt = jpk.pack_text(s, a, extra=extra)
        tt = tpk.pack_text(s, ALPHABETS[alpha], extra=extra, device="cpu")
    else:
        jt = jnp.asarray(a.pad_string(s, extra=extra))
        tt = torch.from_numpy(a.pad_string(s, extra=extra))
    want = jb.lcp_from_text(jt, pa, pb)
    got = tb.lcp_from_text(tt, torch.from_numpy(pa), torch.from_numpy(pb))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() > 256  # more than one saturated round


@pytest.mark.parametrize("alpha", ["dna", "protein_class", "byte"])
def test_lcp_from_text_periodic_equal(alpha):
    """A periodic text whose pairs stay saturated for at least three rounds
    (w = 64, 128, 256, ...), with the pairs chained as the node build's
    adjacent leaves are (``pos_a[i + 1] == pos_b[i]``), equals JAX's."""
    a = J_ALPHABETS[alpha]
    n = 1200
    s = a.random_string(n, seed=5)
    s[:n] = np.tile(s[:19], n // 19 + 1)[:n]  # period 19, then the terminal
    s[n - 40] = (int(s[n - 40]) + 1) % (a.base - 1)
    chain = np.arange(0, 19 * 12, 19)
    pa = np.concatenate([chain[:-1], [3, 5, n - 1]])
    pb = np.concatenate([chain[1:], [3 + 38, 600, n - 2]])
    extra = 2 * 256 + 8
    jt = jpk.pack_text(s, a, extra=extra)
    tt = tpk.pack_text(s, ALPHABETS[alpha], extra=extra, device="cpu")
    want = jb.lcp_from_text(jt, pa, pb)
    got = tb.lcp_from_text(tt, torch.from_numpy(pa), torch.from_numpy(pb))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() > 64 + 128 + 256  # three saturated rounds at least


@pytest.mark.parametrize("alpha", ["dna"])
def test_boff_rows_from_text_equal(alpha):
    a = J_ALPHABETS[alpha]
    s = a.random_string(700, seed=9)
    n_total = len(s)
    rng = np.random.default_rng(9)
    ell = np.full((3, 40), n_total, np.int32)
    for r, f in enumerate((38, 5, 1)):
        ell[r, :f] = rng.permutation(n_total)[:f]
    jt = jpk.pack_text(s, a, extra=520) if alpha == "dna" else \
        jnp.asarray(a.pad_string(s, extra=520))
    tt = tpk.pack_text(s, ALPHABETS[alpha], extra=520, device="cpu") \
        if alpha == "dna" else torch.from_numpy(a.pad_string(s, extra=520))
    want = np.asarray(jb.boff_rows_from_text(jt, jnp.asarray(ell), n_total))
    got = tb.boff_rows_from_text(tt, torch.from_numpy(ell), n_total)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    want_n = jb.build_parallel_batch_from_text(jt, jnp.asarray(ell), n_total)
    got_n = tb.build_parallel_batch_from_text(tt, torch.from_numpy(ell),
                                              n_total)
    np.testing.assert_array_equal(got_n.parent.numpy(),
                                  np.asarray(want_n.parent))


def test_unpad_nodes_row_and_build_numpy_equal():
    """Row extraction of a padded batch (row by row, and all rows at once
    on the device), and the sequential builder, on the same rows:
    identical arrays and intervals in both packages."""
    rng = np.random.default_rng(4)
    n_total, f_pad = 600, 30
    fs = (28, 1, 13)
    ell = np.full((3, f_pad), n_total, np.int32)
    boff = np.zeros((3, f_pad), np.int32)
    for r, f in enumerate(fs):
        ell[r, :f] = rng.permutation(n_total)[:f]
        boff[r, :f] = rng.integers(1, 5, size=f)
    nodes = tb.build_parallel_batch(torch.from_numpy(ell),
                                    torch.from_numpy(boff), n_total)
    batched = tb.unpad_nodes_rows(nodes, fs)
    for r, f in enumerate(fs):
        row = [x[r].numpy() for x in nodes[:3]]
        got = tb.unpad_nodes_row(*row, f)
        want = jb.unpad_nodes_row(*row, f)
        for a, b, c in zip(got, want, batched[r]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            np.testing.assert_array_equal(np.asarray(c), np.asarray(b))
        seq_t = tb.build_numpy(ell[r, :f], boff[r, :f], n_total)
        seq_j = jb.build_numpy(ell[r, :f], boff[r, :f], n_total)
        for a, b in zip(seq_t, seq_j):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert tb.nodes_to_intervals(got) == jb.nodes_to_intervals(want)
        assert tb.nodes_to_intervals(seq_t) == jb.nodes_to_intervals(seq_j)

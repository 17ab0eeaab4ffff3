"""PyTorch port vs the JAX package: ``DeviceIndex`` search and archives.

A JAX ``DeviceIndex`` carried into the port (``from_blobs``, or an npz
file) answers ``find_batch`` identically, and a port archive loads in the
JAX package and answers identically too.  The port runs on the CPU.
Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from repro.core import ref
from repro.core.alphabet import ALPHABETS as J_ALPHABETS
from repro.core.api import EraConfig as JConfig
from repro.core.api import EraIndexer as JIndexer
from repro.core.query import DeviceIndex as JDeviceIndex
from repro.core.query import route_depth as j_route_depth
from repro_torch.core.query import DeviceIndex, route_depth


def _jax_index(alpha, n, mem, seed, **kw):
    a = J_ALPHABETS[alpha]
    s = a.random_string(n, seed=seed)
    cfg = JConfig(memory_bytes=mem, r_bytes=128, build_impl="none")
    return s, JIndexer(a, cfg).build_device(s, **kw)


def _patterns(s, n_sym, rng, count=30):
    pats = []
    for _ in range(count):
        m = int(rng.integers(1, 14))
        i = int(rng.integers(0, len(s) - 1 - m))
        pats.append(np.asarray(s[i : i + m]))
    for _ in range(8):
        pats.append(rng.integers(0, n_sym, size=int(rng.integers(1, 9)))
                    .astype(np.uint8))
    return pats


@pytest.mark.parametrize("alpha,n,mem", [("dna", 800, 512), ("dna", 1500, 8192),
                                         ("protein_class", 700, 4096)])
def test_jax_blobs_answer_identically(alpha, n, mem):
    s, jdev = _jax_index(alpha, n, mem, seed=n + mem)
    tdev = DeviceIndex.from_blobs(jdev.to_blobs(), device="cpu")
    rng = np.random.default_rng(n)
    pats = _patterns(s, len(J_ALPHABETS[alpha].symbols), rng)
    for p, g, w in zip(pats, tdev.find_batch(pats), jdev.find_batch(pats)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, ref.occurrences(s, p))


def test_ranges_equal_jax():
    s, jdev = _jax_index("dna", 1200, 1024, seed=3)
    tdev = DeviceIndex.from_blobs(jdev.to_blobs(), device="cpu")
    pats = _patterns(s, 4, np.random.default_rng(5))
    padded, lengths, route = jdev.pad_batch(pats)
    tp, tl, tr = tdev.pad_batch(pats)
    for a, b in ((padded, tp), (lengths, tl), (route, tr)):
        np.testing.assert_array_equal(a, b)
    js, jc = jdev.find_batch_ranges(padded, lengths, route)
    ts, tc = tdev.find_batch_ranges(tp, tl, tr)
    assert ts.dtype == torch.int32 and tc.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_archives_load_both_ways(tmp_path):
    s, jdev = _jax_index("dna", 1000, 2048, seed=9)
    jdev.save(str(tmp_path / "jax_index"))
    tdev = DeviceIndex.load(str(tmp_path / "jax_index"), device="cpu")
    tdev.save(str(tmp_path / "port_index.npz"))
    back = JDeviceIndex.load(str(tmp_path / "port_index.npz"))
    jb, tb, bb = jdev.to_blobs(), tdev.to_blobs(), back.to_blobs()
    assert set(jb) == set(tb) == set(bb)
    for key in jb:
        assert tb[key].dtype == jb[key].dtype, key
        np.testing.assert_array_equal(tb[key], jb[key], err_msg=key)
        np.testing.assert_array_equal(bb[key], jb[key], err_msg=key)
    pats = _patterns(s, 4, np.random.default_rng(1))
    for a, b in zip(back.find_batch(pats), jdev.find_batch(pats)):
        np.testing.assert_array_equal(a, b)


def test_string_codes_round_trip():
    s, jdev = _jax_index("dna", 600, 2048, seed=2)
    tdev = DeviceIndex.from_blobs(jdev.to_blobs(), device="cpu")
    np.testing.assert_array_equal(tdev.string_codes(), s)
    assert tdev.s_text.nbytes == jdev.string_nbytes and tdev.s_text.bits == 2


def test_terminal_bearing_batch_raises():
    s, jdev = _jax_index("dna", 400, 2048, seed=77)
    tdev = DeviceIndex.from_blobs(jdev.to_blobs(), device="cpu")
    pats = [np.asarray(s[10:16]), np.array([0, 4], np.uint8)]
    with pytest.raises(ValueError, match="terminal code"):
        tdev.find_batch(pats)


def test_byte_compare_knob_raises(monkeypatch):
    s, jdev = _jax_index("dna", 400, 2048, seed=78)
    tdev = DeviceIndex.from_blobs(jdev.to_blobs(), device="cpu")
    monkeypatch.setenv("REPRO_WORD_COMPARE", "byte")
    with pytest.raises(NotImplementedError, match="A7"):
        tdev.find_batch([np.asarray(s[3:9])])


def test_byte_archive_raises():
    a = J_ALPHABETS["dna"]
    s = a.random_string(300, seed=1)
    jdev = JIndexer(a, JConfig(memory_bytes=2048, build_impl="none")
                    ).build_device(s, packing="bytes")
    with pytest.raises(NotImplementedError, match="A7"):
        DeviceIndex.from_blobs(jdev.to_blobs(), device="cpu")


def test_pad_batch_validation():
    s, jdev = _jax_index("dna", 300, 2048, seed=4, max_pattern_len=16)
    tdev = DeviceIndex.from_blobs(jdev.to_blobs(), device="cpu")
    with pytest.raises(ValueError, match="empty"):
        tdev.pad_batch([])
    with pytest.raises(ValueError, match="max_pattern_len"):
        tdev.pad_batch([np.zeros(20, np.uint8)])
    with pytest.raises(ValueError, match="outside"):
        tdev.pad_batch([np.array([9], np.uint8)])
    padded, lengths, _ = tdev.pad_batch([np.array([1, 2], np.uint8)],
                                        m_pad=8, b_pad=3)
    assert padded.shape == (3, 8) and lengths.tolist() == [2, 1, 1]


@pytest.mark.parametrize("base,max_plen,cap", [(5, 9, 1 << 18), (5, 2, 1 << 18),
                                               (11, 6, 1 << 12), (5, 1, 4)])
def test_route_depth_equal(base, max_plen, cap):
    assert route_depth(base, max_plen, cap) == j_route_depth(base, max_plen, cap)

"""PyTorch port vs the JAX package: ``DeviceIndex`` search and archives.

A JAX ``DeviceIndex`` carried into the port (``from_blobs``, or an npz
file) answers ``find_batch`` identically, and a port archive loads in the
JAX package and answers identically too — dense (``s_words``) and byte
(``s_padded``) archives alike.  A dense index answers a batch carrying the
terminal code through the byte-key probe, as JAX does.  The port runs on
the CPU.  Tolerance: exact.
"""

import dataclasses

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


@pytest.mark.parametrize("alpha,n,mem,packing", [
    ("dna", 800, 512, "auto"), ("dna", 1500, 8192, "auto"),
    ("protein_class", 700, 4096, "auto"), ("protein", 900, 4096, "auto"),
    ("byte", 700, 4096, "auto"), ("dna", 900, 2048, "bytes"),
])
def test_jax_blobs_answer_identically(alpha, n, mem, packing):
    s, jdev = _jax_index(alpha, n, mem, seed=n + mem, packing=packing)
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


def _terminal_patterns(s, terminal):
    """Patterns that end in the terminal code: the last k symbols of the
    string with its terminal, and every [c, terminal]."""
    n = len(s)
    pats = [np.asarray(s[n - k:]) for k in (1, 2, 3, 5, 9, 17)]
    pats += [np.array([c, terminal], np.uint8) for c in range(terminal)]
    return pats


def test_terminal_bearing_batch_raises():
    """Once refused, now answered: a dense DNA index serves a batch that
    carries the terminal code on byte keys (``search_bounds_packed``),
    equal to JAX and to the brute-force scan, and counts no word-probe
    launch."""
    s, jdev = _jax_index("dna", 400, 2048, seed=77)
    tdev = DeviceIndex.from_blobs(jdev.to_blobs(), device="cpu")
    pats = [np.asarray(s[10:16])] + _terminal_patterns(s, 4)
    assert not tdev._word_gate(tdev.pad_batch(pats)[0], None)
    assert tdev._word_gate(tdev.pad_batch(pats[:1])[0], None)
    got = tdev.find_batch(pats)
    for p, g, w in zip(pats, got, jdev.find_batch(pats)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, ref.occurrences(s, p))
    assert got[1].tolist() == [len(s) - 1]  # the terminal itself


@pytest.mark.parametrize("alpha", ["protein_class", "byte"])
def test_terminal_bearing_batch_other_alphabets(alpha):
    s, jdev = _jax_index(alpha, 500, 4096, seed=79,
                         packing="dense" if alpha == "byte" else "auto")
    tdev = DeviceIndex.from_blobs(jdev.to_blobs(), device="cpu")
    assert tdev.packed
    a = J_ALPHABETS[alpha]
    pats = _terminal_patterns(s, a.terminal_code)[:20] + [np.asarray(s[5:9])]
    for p, g, w in zip(pats, tdev.find_batch(pats), jdev.find_batch(pats)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, ref.occurrences(s, p))


def test_byte_compare_knob_raises(monkeypatch):
    """Once refused, now answered: under ``REPRO_WORD_COMPARE=byte`` a
    dense index searches every batch on byte keys
    (``search_bounds_packed``), equal to JAX under the same leg and to
    the brute-force scan."""
    s, jdev = _jax_index("dna", 400, 2048, seed=78)
    tdev = DeviceIndex.from_blobs(jdev.to_blobs(), device="cpu")
    monkeypatch.setenv("REPRO_WORD_COMPARE", "byte")
    pats = [np.asarray(s[3:9]), np.asarray(s[100:121])] + \
        _terminal_patterns(s, 4)[:5]
    assert not tdev._word_gate(tdev.pad_batch(pats[:1])[0], None)
    for p, g, w in zip(pats, tdev.find_batch(pats), jdev.find_batch(pats)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, ref.occurrences(s, p))


def test_byte_archive_raises():
    """Once refused, now loaded: a JAX byte archive (``s_padded`` and the
    4-entry meta, no epoch) answers as JAX does."""
    a = J_ALPHABETS["dna"]
    s = a.random_string(300, seed=1)
    jdev = JIndexer(a, JConfig(memory_bytes=2048, build_impl="none")
                    ).build_device(s, packing="bytes")
    blobs = jdev.to_blobs()
    blobs["meta"] = blobs["meta"][:4]  # an archive from before epochs
    tdev = DeviceIndex.from_blobs(blobs, device="cpu")
    assert not tdev.packed and tdev.epoch == 0 and tdev.s_bits == 8
    np.testing.assert_array_equal(tdev.string_codes(), s)
    pats = _patterns(s, 4, np.random.default_rng(3))
    for g, w in zip(tdev.find_batch(pats), jdev.find_batch(pats)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("alpha,packing", [("protein", "auto"),
                                           ("byte", "auto"),
                                           ("dna", "bytes")])
def test_byte_archives_load_both_ways(tmp_path, alpha, packing):
    """Byte archives (C8: ``s_padded``, meta of 4 + the epoch at meta[4])
    round-trip JAX → port → JAX, array for array."""
    s, jdev = _jax_index(alpha, 700, 4096, seed=12, packing=packing)
    jdev = dataclasses.replace(jdev, epoch=3)
    jdev.save(str(tmp_path / "jax_index"))
    tdev = DeviceIndex.load(str(tmp_path / "jax_index"), device="cpu")
    assert tdev.epoch == 3 and not tdev.packed
    tdev.save(str(tmp_path / "port_index.npz"))
    back = JDeviceIndex.load(str(tmp_path / "port_index.npz"))
    jb, tb, bb = jdev.to_blobs(), tdev.to_blobs(), back.to_blobs()
    assert set(jb) == set(tb) == set(bb) and "s_padded" in tb
    assert tb["meta"].tolist()[4] == 3 and tb["meta"].size == 5
    for key in jb:
        assert tb[key].dtype == jb[key].dtype, key
        np.testing.assert_array_equal(tb[key], jb[key], err_msg=key)
        np.testing.assert_array_equal(bb[key], jb[key], err_msg=key)
    pats = _patterns(s, len(J_ALPHABETS[alpha].symbols),
                     np.random.default_rng(4))
    for a, b in zip(back.find_batch(pats), tdev.find_batch(pats)):
        np.testing.assert_array_equal(a, b)


def test_read_symbols_equal_both_layouts():
    for alpha, packing in (("dna", "auto"), ("protein", "auto")):
        s, jdev = _jax_index(alpha, 500, 4096, seed=5, packing=packing)
        tdev = DeviceIndex.from_blobs(jdev.to_blobs(), device="cpu")
        pos = np.array([0, 7, 250, 490, 499, 500], np.int32)
        np.testing.assert_array_equal(tdev.read_symbols(pos, 13).numpy(),
                                      np.asarray(jdev.read_symbols(pos, 13)))
        assert tdev.string_nbytes == jdev.string_nbytes
        if not tdev.packed:
            with pytest.raises(AttributeError):
                DeviceIndex.from_blobs(_jax_index("dna", 300, 2048, seed=1)[1]
                                       .to_blobs(), device="cpu").s_padded


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

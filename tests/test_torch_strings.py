"""PyTorch port vs the JAX package: the string readers.

``load_fasta`` must return the JAX package's codes on files with headers,
``;`` comments, blank lines, lower case, ``N`` and ragged lines, with and
without ``max_symbols``; ``BlockStream`` must yield the same blocks and
``StreamStats``.  Numpy only on both sides.  Tolerance: exact.
"""

import numpy as np
import pytest

from repro.core.alphabet import ALPHABETS as J_ALPHABETS
from repro.data.strings import BlockStream as JBlockStream
from repro.data.strings import load_fasta as j_load_fasta
from repro_torch.core.alphabet import ALPHABETS
from repro_torch.data.strings import BlockStream, dataset, load_fasta

FASTA = """>chr1 a header
ACGTNNacgtn
;a comment line
  ACGTACGTAC

>chr2
ttttGGGG
\tNNNN\t
;
CA
"""


def _write(tmp_path, text):
    path = tmp_path / "x.fa"
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("max_symbols", [None, 0, 1, 5, 11, 12, 21, 30, 10_000])
def test_load_fasta_equal(tmp_path, max_symbols):
    path = _write(tmp_path, FASTA)
    got = load_fasta(path, ALPHABETS["dna"], max_symbols=max_symbols)
    want = j_load_fasta(path, J_ALPHABETS["dna"], max_symbols=max_symbols)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert got[-1] == ALPHABETS["dna"].terminal_code


@pytest.mark.parametrize("name", ["dna", "protein"])
def test_load_fasta_round_trip(tmp_path, name):
    """A generated string written as 80-column records reads back equal
    (protein ``N`` is a real symbol that the reader maps to the first one,
    as JAX does)."""
    s, alpha = dataset(name, 2_000, seed=4)
    text = "".join(alpha.symbols[c] for c in s[:-1])
    lines = [text[i:i + 80] for i in range(0, len(text), 80)]
    path = _write(tmp_path, ">r1\n" + "\n".join(lines[:10]) + "\n>r2\n"
                  + "\n".join(lines[10:]) + "\n")
    got = load_fasta(path, alpha)
    np.testing.assert_array_equal(got, j_load_fasta(path, J_ALPHABETS[name]))
    if name == "dna":
        np.testing.assert_array_equal(got, s)


def test_load_fasta_empty_and_bad(tmp_path):
    path = _write(tmp_path, ">only a header\n;\n\n")
    np.testing.assert_array_equal(
        load_fasta(path, ALPHABETS["dna"]),
        j_load_fasta(path, J_ALPHABETS["dna"]))
    bad = _write(tmp_path, ">h\nACGX\n")
    with pytest.raises(ValueError):
        load_fasta(bad, ALPHABETS["dna"])
    with pytest.raises(ValueError):
        j_load_fasta(bad, J_ALPHABETS["dna"])


@pytest.mark.parametrize("block", [7, 64, 1 << 20])
def test_block_stream_equal(block):
    s, _ = dataset("dna", 3_000, seed=2)
    got, want = BlockStream(s, block_bytes=block), JBlockStream(s, block)
    for a, b in zip(got.read_all(), want.read_all(), strict=True):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(block)
    offs = rng.integers(0, len(s) - 8, size=40)
    for w in (1, 8):
        pairs = zip(got.read_for_offsets(offs, w),
                    want.read_for_offsets(offs, w), strict=True)
        for (ba, a), (bb, b) in pairs:
            assert ba == bb
            np.testing.assert_array_equal(a, b)
    assert list(got.read_for_offsets(np.zeros(0, np.int64), 4)) == []
    assert got.stats.__dict__ == want.stats.__dict__
    assert got.stats.blocks_read > 0

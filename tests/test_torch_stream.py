"""PyTorch port vs the JAX package: out-of-core streaming and append.

The streaming prepare (``subtree_prepare_stream``) must equal the JAX
package's, all six ``PrepareState`` fields, and the port's one-shot
``subtree_prepare_batch`` (five result fields where the per-chunk range
schedules diverge: ``start`` is a schedule-dependent cursor), with the
timing-free ``StreamReport`` fields equal to JAX's.  ``build_stream`` and
``append_device`` must give the JAX package's index arrays, lookups,
epochs and timing-free ``AppendReport`` fields, and equal a rebuild.  The
planner, ``pack_text_stream``, ``migrate_archive`` and the epoch archives
are held against JAX the same way.  The port runs on the CPU.  Tolerance:
exact.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import iomodel as jio
from repro.core import packing as jpk
from repro.core import prepare as jprep
from repro.core.alphabet import ALPHABETS as J_ALPHABETS
from repro.core.api import EraConfig as JConfig
from repro.core.api import EraIndexer as JIndexer
from repro.core.query import DeviceIndex as JDeviceIndex
from repro.launch.warmstart import migrate_archive as j_migrate_archive
from repro_torch.core import iomodel as tio
from repro_torch.core import packing as tpk
from repro_torch.core import prepare as tprep
from repro_torch.core.alphabet import ALPHABETS
from repro_torch.core.api import EraConfig, EraIndexer
from repro_torch.core.query import DeviceIndex
from repro_torch.data.strings import dataset
from repro_torch.launch.serving import AsyncServer, ServeConfig
from repro_torch.launch.warmstart import migrate_archive

ROOT = Path(__file__).resolve().parents[1]
ALL_FIELDS = ("L", "start", "area", "b_off", "b_c1", "b_c2")
RESULT_FIELDS = tuple(f for f in ALL_FIELDS if f != "start")
INDEX_FIELDS = ("ell", "sub_off", "sub_freq", "sub_prefix", "sub_plen",
                "win_lo", "win_hi")
REPORT_FIELDS = ("n_chunks", "overlap", "groups", "iterations",
                 "chunk_iters", "bytes_copied")
APPEND_FIELDS = ("n_old", "n_new", "b_star", "n_prefixes", "n_affected",
                 "leaves_rebuilt", "leaves_reused", "partition_fallback")


def _indexers(name, mem, **cfg_kw):
    kw = dict(memory_bytes=mem, build_impl="none", **cfg_kw)
    return (JIndexer(J_ALPHABETS[name], JConfig(**kw)),
            EraIndexer(ALPHABETS[name], EraConfig(**kw), device="cpu"))


def _workload(name, n, mem, **cfg_kw):
    """Both packages' partitions of one string: (s, jix, tix, jgroups,
    tgroups, capacity)."""
    s, _ = dataset(name, n, seed=0)
    jix, tix = _indexers(name, mem, **cfg_kw)
    jg, tg = jix.partition(s), tix.partition(s)
    cap = tix._capacity(tg)
    assert cap == jix._capacity(jg) and len(jg) == len(tg)
    return s, jix, tix, jg, tg, cap


def _assert_state(want, got, fields, *, jax_side=True):
    for field in fields:
        w = getattr(want, field)
        w = np.asarray(w) if jax_side else w.numpy()
        g = getattr(got, field)
        assert g.dtype == torch.int32 and g.device.type == "cpu", field
        np.testing.assert_array_equal(w, g.numpy(), err_msg=field)


def _assert_report(jrep, trep):
    for key in REPORT_FIELDS:
        assert getattr(jrep, key) == getattr(trep, key), key


def _assert_index(want, got, *, jax_side=True):
    for field in INDEX_FIELDS:
        w = getattr(want, field)
        w = np.asarray(w) if jax_side else w.numpy()
        np.testing.assert_array_equal(w, getattr(got, field).numpy(),
                                      err_msg=field)
    np.testing.assert_array_equal(np.asarray(want.string_codes()),
                                  got.string_codes())
    assert want.epoch == got.epoch


def _assert_lookups(want, got, pats):
    for a, b in zip(want.find_batch(pats), got.find_batch(pats)):
        np.testing.assert_array_equal(a, b)


def _appended(s, alphabet, m, seed=3):
    """s_new = S_old's real symbols + m fresh symbols + terminal (the JAX
    tests' rule)."""
    rng = np.random.default_rng(seed)
    extra = rng.integers(0, alphabet.base - 1, size=m, dtype=np.uint8)
    return np.concatenate([s[:-1], extra, s[-1:]])


# ---- the planner and the I/O model ------------------------------------------

@pytest.mark.parametrize("n_groups,capacity,budget,reserved,double", [
    (37, 100, None, 0, True),          # unbounded: one chunk
    (10, 100, 1, 0, True),             # the floor: one group a chunk
    (10, 100, 0, 0, False),
    (11, 64, 2 * 3 * 24 * 64, 0, True),
    (12, 64, 4 * 24 * 64, 0, True),
    (12, 64, 4 * 24 * 64, 0, False),   # single buffer: twice the groups
    (12, 64, 2 * 4 * 24 * 64, 2 * 2 * 24 * 64, True),  # reserved bytes
    (12, 64, 100, 10 ** 9, True),      # reserved above the budget
    (5, 7, 10 ** 12, 0, True),         # huge: one chunk
    (126, 1_258_291, 126 * 24 * 1_258_291 // 8, 0, True),  # the smoke's
    (0, 64, None, 0, True),            # no groups
    (0, 64, 1000, 0, False),
])
def test_plan_stream_equal(n_groups, capacity, budget, reserved, double):
    kw = dict(budget_bytes=budget, reserved_bytes=reserved,
              double_buffer=double)
    want = jio.plan_stream(n_groups, capacity, **kw)
    got = tio.plan_stream(n_groups, capacity, **kw)
    assert got.chunks == want.chunks
    assert got.describe() == want.describe()
    assert (got.peak_bytes, got.reserved_bytes) == (want.peak_bytes,
                                                    want.reserved_bytes)
    assert tio.state_bytes_per_group(capacity) == \
        jio.state_bytes_per_group(capacity)
    assert (tio.STATE_FIELDS, tio.STATE_CELL_BYTES) == (jio.STATE_FIELDS,
                                                        jio.STATE_CELL_BYTES)


@pytest.mark.parametrize("block", [64, 1 << 20])
def test_io_model_equal(block):
    rng = np.random.default_rng(block)
    offs = [np.sort(rng.integers(0, 5000, size=k)) for k in (40, 0, 7, 300)]
    ranges = [4, 8, 16, 256]
    want = jio.model_prepare_io(offs, ranges, 5000, block_bytes=block)
    got = tio.model_prepare_io(offs, ranges, 5000, block_bytes=block)
    assert got.__dict__ == want.__dict__
    for p, g in ((37, 5), (0, 0), (9, 1)):
        assert tio.amortization_factor(p, g) == jio.amortization_factor(p, g)


# ---- the host state and the streaming prepare -------------------------------

@pytest.mark.parametrize("name,n,mem", [("dna", 6000, 1 << 14),
                                        ("protein", 4000, 1 << 14),
                                        ("byte", 3000, 1 << 16)])
def test_host_init_batch_equal(name, n, mem):
    _, _, _, jg, tg, cap = _workload(name, n, mem)
    _assert_state(jprep.init_batch(jg, cap),
                  tprep._host_init_batch(tg, cap), ALL_FIELDS)
    with pytest.raises(ValueError):
        tprep._host_init_batch([], cap)


@pytest.mark.parametrize("name,n", [("dna", 30_000), ("protein", 16_000),
                                    ("byte", 9_000)])
@pytest.mark.parametrize("budget", ["eighth", "unbounded", "one_byte",
                                    "sync"])
def test_stream_six_fields(name, n, budget):
    """128 KB: f_max = 2457, so the range saturates and every chunk's
    schedule is the global one: all six fields equal the one-shot build."""
    s, jix, tix, jg, tg, cap = _workload(name, n, 128 << 10)
    ecfg = tix.config.elastic_config()
    total = len(tg) * tio.state_bytes_per_group(cap)
    kw = {"eighth": dict(device_budget=total // 8),
          "unbounded": {},
          "one_byte": dict(device_budget=1),
          "sync": dict(device_budget=total // 8, overlap=False)}[budget]
    jst, jrep = jprep.subtree_prepare_stream(
        jix._device_text(s), jg, cap, jix.config.elastic_config(), **kw)
    tst, trep = tprep.subtree_prepare_stream(tix._device_text(s), tg, cap,
                                             ecfg, **kw)
    _assert_state(jst, tst, ALL_FIELDS)
    _assert_report(jrep, trep)
    one_shot = tprep.subtree_prepare_batch(tix._device_text(s), tg, cap, ecfg)
    _assert_state(one_shot, tst, ALL_FIELDS, jax_side=False)
    assert trep.n_chunks == {"unbounded": 1, "one_byte": len(tg)}.get(
        budget, trep.n_chunks)
    assert trep.n_chunks >= 2 or budget == "unbounded"
    assert trep.bytes_copied == len(tg) * tio.state_bytes_per_group(cap)
    assert sum(trep.chunk_iters) == trep.iterations
    if budget == "sync":
        assert trep.copy_hidden_s == 0.0 and trep.overlap_frac == 0.0
    assert 0.0 <= trep.overlap_frac <= 1.0


def test_stream_divergent_schedule():
    """r_bytes=512: the range follows each chunk's own active count, so
    chunk schedules diverge from the global one — ``start`` may differ
    from the one-shot build, no result field may; against the JAX stream
    every field is equal."""
    s, jix, tix, jg, tg, cap = _workload("dna", 12_000, 16 << 10,
                                         r_bytes=512)
    ecfg = tix.config.elastic_config()
    budget = len(tg) * tio.state_bytes_per_group(cap) // 8
    jst, jrep = jprep.subtree_prepare_stream(
        jix._device_text(s), jg, cap, jix.config.elastic_config(),
        device_budget=budget)
    stats = tprep.PrepareStats()
    tst, trep = tprep.subtree_prepare_stream(tix._device_text(s), tg, cap,
                                             ecfg, device_budget=budget,
                                             stats=stats)
    assert trep.n_chunks >= 2
    _assert_state(jst, tst, ALL_FIELDS)
    _assert_report(jrep, trep)
    assert stats.iterations == trep.iterations == len(stats.ranges)
    one_shot = tprep.subtree_prepare_batch(tix._device_text(s), tg, cap, ecfg)
    _assert_state(one_shot, tst, RESULT_FIELDS, jax_side=False)


def test_stream_empty_groups_raise():
    s, _, tix, _, tg, cap = _workload("dna", 2_000, 64 << 10)
    with pytest.raises(ValueError):
        tprep.subtree_prepare_stream(tix._device_text(s), [], cap,
                                     tix.config.elastic_config())


@pytest.mark.parametrize("env", [{"REPRO_SORT": "lexsort"},
                                 {"REPRO_COMPACT": "off"},
                                 {"REPRO_WORD_COMPARE": "byte"}])
def test_stream_oracle_legs(monkeypatch, env):
    """Each oracle knob, read by both packages from the environment."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    s, jix, tix, jg, tg, cap = _workload("dna", 8_000, 1 << 12)
    jst, jrep = jprep.subtree_prepare_stream(
        jix._device_text(s), jg, cap, jix.config.elastic_config(),
        device_budget=1 << 16)
    tst, trep = tprep.subtree_prepare_stream(
        tix._device_text(s), tg, cap, tix.config.elastic_config(),
        device_budget=1 << 16)
    assert trep.n_chunks > 1
    _assert_state(jst, tst, ALL_FIELDS)
    _assert_report(jrep, trep)


# ---- build_stream -----------------------------------------------------------

@pytest.mark.parametrize("name,n,overlap", [("dna", 30_000, True),
                                            ("dna", 30_000, False),
                                            ("protein", 16_000, True)])
def test_build_stream_equal(name, n, overlap):
    """The index equals the port's one-shot ``build_device`` and, with
    overlap (JAX's default), JAX's ``build_stream``; the budget is
    ``test_stream_six_fields``'s eighth, so JAX reuses its compiled
    steps."""
    s, jix, tix, _, tg, cap = _workload(name, n, 128 << 10)
    budget = len(tg) * tio.state_bytes_per_group(cap) // 8
    one_shot = tix.build_device(s, max_pattern_len=64)
    tdev, trep = tix.build_stream(s, device_budget=budget, overlap=overlap,
                                  max_pattern_len=64)
    assert trep.n_chunks >= 2 and trep.overlap == overlap
    _assert_index(one_shot, tdev, jax_side=False)
    assert tdev.device.type == "cpu"
    pats = [s[i:i + 9] for i in range(0, 256, 4)]
    _assert_lookups(one_shot, tdev, pats)
    if overlap:
        jdev, jrep = jix.build_stream(s, device_budget=budget,
                                      max_pattern_len=64)
        _assert_report(jrep, trep)
        _assert_index(jdev, tdev)
        assert tdev.packed == jdev.packed
        _assert_lookups(jdev, tdev, pats)


# ---- incremental append -----------------------------------------------------

@pytest.mark.parametrize("n,mem,m,new_mem", [
    (24_000, 128 << 10, 1_500, None),   # every sub-tree affected
    (8_000, 1 << 12, 40, None),         # most leaf segments reused
    (24_000, 64 << 10, 900, 1 << 20),   # a larger f_max: the full scan
])
def test_append_equal(n, mem, m, new_mem):
    s, _ = dataset("dna", n, seed=0)
    jix, tix = _indexers("dna", mem)
    jdev = jix.build_device(s, max_pattern_len=64)
    tdev = tix.build_device(s, max_pattern_len=64)
    if new_mem is not None:  # append under another budget
        jix, tix = _indexers("dna", new_mem)
    s_new = _appended(s, ALPHABETS["dna"], m)
    jdev2, jrep = jix.append_device(jdev, s_new)
    tdev2, trep = tix.append_device(tdev, s_new)
    for key in APPEND_FIELDS:
        assert getattr(jrep, key) == getattr(trep, key), key
    assert trep.partition_fallback == (new_mem is not None)
    assert trep.leaves_rebuilt + trep.leaves_reused == tdev2.n_leaves
    assert trep.n_new == trep.n_old + m and trep.t_total >= 0
    _assert_index(jdev2, tdev2)
    assert tdev2.epoch == tdev.epoch + 1 == 1
    full = tix.build_device(s_new, max_pattern_len=64)
    _assert_index(full, dataclasses.replace(tdev2, epoch=0), jax_side=False)
    pats = [s_new[i:i + 8] for i in range(0, 200, 2)]
    pats += [s_new[len(s_new) - 1 - k:len(s_new) - 1] for k in (4, 9, 17)]
    _assert_lookups(full, tdev2, pats)


def test_two_appends_equal_oracle_rebuild(monkeypatch):
    """Two appends in a row: epoch + 2, the index equal to a rebuild
    under the lexsort / compaction-off oracle and to JAX's appends."""
    s, _ = dataset("dna", 5_000, seed=0)
    jix, tix = _indexers("dna", 1 << 12)
    alpha = ALPHABETS["dna"]
    rng = np.random.default_rng(3)
    s_new = np.concatenate([s[:-1], rng.integers(0, alpha.base - 1, 800,
                                                 dtype=np.uint8), s[-1:]])
    s_new2 = np.concatenate([s_new[:-1], rng.integers(
        0, alpha.base - 1, 400, dtype=np.uint8), s_new[-1:]])
    tdev = tix.build_device(s)
    jdev = jix.build_device(s)
    for seq in (s_new, s_new2):
        tdev, _ = tix.append_device(tdev, seq)
        jdev, _ = jix.append_device(jdev, seq)
    assert tdev.epoch == 2
    _assert_index(jdev, tdev)
    monkeypatch.setenv("REPRO_SORT", "lexsort")
    monkeypatch.setenv("REPRO_COMPACT", "off")
    rebuilt = EraIndexer(alpha, tix.config, device="cpu").build_device(s_new2)
    for field in INDEX_FIELDS:
        assert torch.equal(getattr(rebuilt, field), getattr(tdev, field)), \
            field


def test_append_rejections():
    s, _ = dataset("dna", 4_000, seed=0)
    _, tix = _indexers("dna", 64 << 10)
    dev = tix.build_device(s, max_pattern_len=64)
    mutated = _appended(s, ALPHABETS["dna"], 100)
    mutated[5] = (mutated[5] + 1) % (ALPHABETS["dna"].base - 1)
    with pytest.raises(ValueError, match="extend"):
        tix.append_device(dev, mutated)    # not an extension
    with pytest.raises(ValueError, match="new symbols"):
        tix.append_device(dev, s)          # not strictly longer


# ---- epoch archives across the two packages ---------------------------------

@pytest.mark.parametrize("pack", ["bytes", "dense"])
def test_epoch_archives_both_ways(tmp_path, pack):
    s, _ = dataset("dna", 6_000, seed=0)
    jix, tix = _indexers("dna", 64 << 10)
    s_new = _appended(s, ALPHABETS["dna"], 200)
    tdev, _ = tix.append_device(
        tix.build_device(s, max_pattern_len=64, packing=pack), s_new)
    jdev, _ = jix.append_device(
        jix.build_device(s, max_pattern_len=64, packing=pack), s_new)
    tdev.save(str(tmp_path / "port"))
    jdev.save(str(tmp_path / "jax"))
    from_port = JDeviceIndex.load(str(tmp_path / "port"))
    from_jax = DeviceIndex.load(str(tmp_path / "jax"), device="cpu")
    assert from_port.epoch == from_jax.epoch == 1
    _assert_index(from_port, tdev)
    _assert_index(jdev, from_jax)
    # the append flattens under the indexer's packing ("auto": dense)
    assert from_jax.packed and from_port.packed


@pytest.mark.parametrize("pack,legacy_meta", [("bytes", 4), ("dense", 6)])
def test_legacy_archives_load_as_epoch_zero(tmp_path, pack, legacy_meta):
    s, _ = dataset("dna", 6_000, seed=0)
    _, tix = _indexers("dna", 64 << 10)
    dev = dataclasses.replace(
        tix.build_device(s, max_pattern_len=64, packing=pack), epoch=3)
    blobs = dev.to_blobs()
    assert blobs["meta"][-1] == 3 and blobs["meta"].size == legacy_meta + 1
    blobs["meta"] = blobs["meta"][:legacy_meta]
    path = str(tmp_path / "legacy.npz")
    np.savez_compressed(path, **blobs)
    assert DeviceIndex.load(path, device="cpu").epoch == 0
    assert JDeviceIndex.load(path).epoch == 0


# ---- the serving swap -------------------------------------------------------

def test_serving_swap_flushes_and_answers_as_fresh():
    s, _ = dataset("dna", 10_000, seed=0)
    _, tix = _indexers("dna", 64 << 10)
    dev = tix.build_device(s, max_pattern_len=64)
    cfg = ServeConfig(pipeline=True, cache_size=256, max_batch=64)
    srv = AsyncServer(dev, cfg)
    pats = [np.asarray(s[i:i + 8], np.int32) for i in range(100)]
    srv.serve(pats)
    assert len(srv.cache) > 0
    s_new = _appended(s, ALPHABETS["dna"], 300)
    dev2, _ = tix.append_device(dev, s_new)
    info = srv.update_index(dev2)
    assert info == {"epoch": 1, "flushed": True, "shards": 1}
    assert len(srv.cache) == 0
    got = srv.serve(pats)
    full = tix.build_device(s_new, max_pattern_len=64)
    want = AsyncServer(full, cfg).serve(pats)
    for (a, _), (b, _) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    warm = len(srv.cache)
    assert warm > 0
    assert not srv.update_index(dev2)["flushed"]  # same epoch: kept
    assert len(srv.cache) == warm


# ---- pack_text_stream and the archive migration -----------------------------

@pytest.mark.parametrize("name", ["dna", "protein", "byte"])
@pytest.mark.parametrize("chunk", [1, 7, 4096])
def test_pack_text_stream_equal(name, chunk):
    alpha = ALPHABETS[name]
    rng = np.random.default_rng(0)
    codes = rng.integers(0, alpha.terminal_code, size=3_333, dtype=np.uint8)
    codes = np.concatenate([codes, [alpha.terminal_code]]).astype(np.uint8)
    pieces = lambda: (codes[i:i + chunk] for i in range(0, codes.size, chunk))
    want = jpk.pack_text_stream(pieces(), J_ALPHABETS[name])
    got = tpk.pack_text_stream(pieces(), alpha, device="cpu")
    np.testing.assert_array_equal(np.asarray(want.words), got.words_numpy())
    assert (got.n_real, got.bits, got.terminal) == (
        int(want.n_real), want.bits, want.terminal)
    one = tpk.pack_text(codes, alpha, device="cpu")
    assert torch.equal(one.words, got.words) and one.n_real == got.n_real


@pytest.mark.parametrize("chunks", [[np.zeros(5, np.uint8)], [],
                                    [np.array([4, 0, 1], np.uint8),
                                     np.zeros(0, np.uint8)]])
def test_pack_text_stream_rejects_unterminated(chunks):
    alpha = ALPHABETS["dna"]
    with pytest.raises(ValueError):
        tpk.pack_text_stream(iter(chunks), alpha, device="cpu")
    with pytest.raises(ValueError):
        jpk.pack_text_stream(iter(chunks), J_ALPHABETS["dna"])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_migrate_archive_both_ways(tmp_path, writer):
    """A byte archive written by one package, migrated by the other: the
    dense archive loads in both and equals a dense build."""
    s, _ = dataset("dna", 8_000, seed=0)
    jix, tix = _indexers("dna", 64 << 10)
    path = str(tmp_path / "idx")
    if writer == "port":
        tix.build_device(s, max_pattern_len=64, packing="bytes").save(path)
        assert j_migrate_archive(path, chunk_symbols=1_000) is True
        assert migrate_archive(path) is False
    else:
        jix.build_device(s, max_pattern_len=64, packing="bytes").save(path)
        assert migrate_archive(path, chunk_symbols=1_000) is True
        assert j_migrate_archive(path) is False
    dense = tix.build_device(s, max_pattern_len=64, packing="dense")
    mig = DeviceIndex.load(path, device="cpu")
    assert mig.packed and mig.epoch == 0
    assert torch.equal(mig.s_text.words, dense.s_text.words)
    _assert_index(dense, mig, jax_side=False)
    jmig = JDeviceIndex.load(path)
    assert jmig.packed
    _assert_index(jmig, mig)
    pats = [s[i:i + 9] for i in range(0, 64, 2)]
    _assert_lookups(dense, mig, pats)


def test_migrate_archive_rejects(tmp_path):
    path = str(tmp_path / "other.npz")
    np.savez_compressed(path, x=np.zeros(3))
    with pytest.raises(ValueError):
        migrate_archive(path)
    with pytest.raises(FileNotFoundError):
        migrate_archive(str(tmp_path / "missing"))


def test_stream_modules_import_no_jax():
    """The new modules stand alone: importing them pulls in no JAX and
    nothing of the JAX package."""
    code = ("import sys\n"
            "import repro_torch.core.iomodel, repro_torch.launch.warmstart\n"
            "import repro_torch.data.strings, repro_torch.core.prepare\n"
            "import repro_torch.launch.stream_bench\n"
            "import repro_torch.core.fabric, repro_torch.launch.mesh\n"
            "import repro_torch.launch.shard_run\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={"PYTHONPATH": str(ROOT / "src"),
                        "PATH": "/usr/bin:/bin"})

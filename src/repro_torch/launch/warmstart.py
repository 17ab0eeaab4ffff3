"""Shared npz warm-start logic for the serving drivers — PyTorch port of
``repro.launch.warmstart``.

``query_serve`` and ``serving`` cache a
:class:`repro_torch.core.query.DeviceIndex` (or, sharded, a
:class:`repro_torch.core.fabric.ShardedIndex` as per-shard archives),
``analytics_serve`` an :class:`repro_torch.core.analytics.AnalyticsEngine`
(the flattened index plus its LCP array), all in the JAX package's npz
layouts: normalize the cache path (``np.savez`` appends ``.npz``, so the
existence check must too), load and validate it against the requested
dataset if the file exists, otherwise build once and save.
:func:`migrate_archive` re-packs a byte-layout archive to dense storage in
place; :func:`migrate_archives` does so for a cache path and its shard
siblings.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core.alphabet import ALPHABETS
from repro_torch.core.fabric import ShardedIndex
from repro_torch.core.query import npz_path
from repro_torch.data.strings import dataset


def normalize_npz(path: str | None) -> str | None:
    """The path ``np.savez_compressed`` will actually write."""
    return None if path is None else npz_path(path)


def shard_archives(index_path: str | None) -> list:
    """The ``{path}_shard{k}.npz`` siblings a sharded index saved under
    ``index_path``, in shard order (empty when there are none)."""
    if index_path is None:
        return []
    return ShardedIndex.shard_files(index_path)


def will_load(index_path: str | None, *, sharded: bool = False) -> bool:
    """True when :func:`load_or_build` would take the cache path.  A
    sharded index writes only ``{path}_shard{k}.npz``, never the base
    ``{path}.npz``: with ``sharded`` any shard archive counts, without it
    only the base archive (the two caches are distinct)."""
    if sharded:
        return bool(shard_archives(index_path))
    path = normalize_npz(index_path)
    return path is not None and os.path.exists(path)


def _alphabet_by_base(base: int):
    for al in ALPHABETS.values():
        if al.base == base:
            return al
    raise ValueError(f"no registered alphabet has base {base}")


def migrate_archive(path: str, *, chunk_symbols: int = 1 << 20,
                    verify: bool = True) -> bool:
    """Re-pack one byte-layout npz archive to dense storage IN PLACE,
    chunk by chunk, without rebuilding the index (the JAX
    ``migrate_archive``; the layouts are the JAX package's, so an archive
    migrated by either package loads in both).

    A byte archive stores the terminal-padded string as ``s_padded`` and a
    4(+epoch)-entry ``meta``; the dense layout stores ``s_words`` (uint32,
    ``Alphabet.dense_bits`` bits a symbol) and extends ``meta`` with
    ``[s_bits, n_real]`` before the epoch.  Every routing and leaf blob is
    carried over as it is.  The string goes through
    :func:`repro_torch.core.packing.pack_text_stream` in
    ``chunk_symbols``-sized chunks, on the host; ``verify`` also packs it
    whole with :func:`pack_text` and requires word-for-word equality
    before anything is written.  The archive is written to
    ``<path>.tmp.npz`` and then renamed over ``path``.

    Returns True when the archive was migrated, False when it was already
    dense.  Raises on a missing or unrecognizable archive.
    """
    path = npz_path(path)
    with np.load(path) as data:
        if "s_words" in data:
            return False
        if "s_padded" not in data or "meta" not in data:
            raise ValueError(f"{path} is not a DeviceIndex archive")
        blobs = {k: data[k] for k in data.files}
    meta = np.asarray(blobs.pop("meta"), np.int64)
    base, max_plen = int(meta[0]), int(meta[3])
    epoch = int(meta[4]) if meta.size > 4 else 0
    alphabet = _alphabet_by_base(base)
    s_padded = np.asarray(blobs.pop("s_padded"), np.uint8)
    # the stored string is terminal-PADDED and shard archives carry the
    # full string whatever their leaf count, so the real length is where
    # the terminal first appears (it only ever occurs at the end)
    term = np.flatnonzero(s_padded == alphabet.terminal_code)
    if term.size == 0:
        raise ValueError(f"{path} stores an unterminated string")
    codes = s_padded[:int(term[0]) + 1]  # real symbols + one terminal
    chunks = (codes[i:i + chunk_symbols]
              for i in range(0, codes.size, chunk_symbols))
    pt = packing.pack_text_stream(chunks, alphabet, extra=max_plen + 8,
                                  device="cpu")
    if verify:
        ref = packing.pack_text(codes, alphabet, extra=max_plen + 8,
                                device="cpu")
        if not (torch.equal(pt.words, ref.words)
                and pt.n_real == ref.n_real):
            raise AssertionError(
                f"streamed re-pack of {path} diverged from pack_text")
    blobs["s_words"] = pt.words_numpy()
    blobs["meta"] = np.array(
        [base, int(meta[1]), int(meta[2]), max_plen,
         pt.bits, pt.n_real, epoch], np.int64)
    tmp = path + ".tmp.npz"   # already .npz-suffixed: savez won't rename it
    np.savez_compressed(tmp, **blobs)
    os.replace(tmp, path)
    return True


def migrate_archives(index_path: str, *, chunk_symbols: int = 1 << 20,
                     verify: bool = True) -> list[str]:
    """Migrate a cache path's byte archives to dense storage: the base
    ``{path}.npz`` (if present) and every ``{path}_shard{k}.npz`` sibling.
    Returns the archive files actually migrated."""
    done = []
    base = normalize_npz(index_path)
    targets = [base] if base and os.path.exists(base) else []
    targets += shard_archives(index_path)
    for f in targets:
        if migrate_archive(f, chunk_symbols=chunk_symbols, verify=verify):
            done.append(f)
    return done


def load_or_build(index_path: str | None, dataset_name: str, n: int,
                  seed: int, *, load: Callable, build: Callable,
                  dev_of: Callable = lambda obj: obj,
                  sharded: bool = False):
    """Load ``load(path)`` from the npz cache, else ``build(s, alphabet)``
    and save.  ``dev_of`` extracts the underlying DeviceIndex (``eng.dev``
    for analytics_serve) for validation and string recovery.  Returns
    ``(obj, s, alphabet, t_seconds)``.

    A cache hit serves whatever string the npz was built from: the
    alphabet base must match, an ``n`` mismatch prints a notice, and
    ``seed`` is not validated (the string comes from the npz itself).
    ``sharded`` takes the per-shard archives (``{path}_shard{k}.npz``):
    any shard archive is a hit, ``load``/``build(...).save`` are the
    :class:`ShardedIndex` pair (which add the suffixes), and the string
    recovered is the full one."""
    path = index_path if sharded else normalize_npz(index_path)
    t0 = time.perf_counter()
    if path and will_load(index_path, sharded=sharded):
        obj = load(path)
        dev = dev_of(obj)
        s = dev.string_codes()  # n_leaves symbols == |S|, any representation
        alphabet = dataset(dataset_name, 1, seed=seed)[1]
        if alphabet.base != dev.base:
            raise ValueError(
                f"dataset {dataset_name!r} (base {alphabet.base}) does not "
                f"match the cached index at {path} (base {dev.base})")
        if len(s) != n + 1:  # dataset() appends the terminal: n -> n+1 codes
            print(f"warmstart: cached index at {path} holds {len(s)} symbols, "
                  f"ignoring requested --n {n}", file=sys.stderr)
    else:
        s, alphabet = dataset(dataset_name, n, seed=seed)
        obj = build(s, alphabet)
        if path:
            obj.save(path)
    return obj, s, alphabet, time.perf_counter() - t0

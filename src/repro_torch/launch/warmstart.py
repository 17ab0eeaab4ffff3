"""Shared npz warm-start logic for the serving drivers — PyTorch port of
``repro.launch.warmstart`` (the single-archive path).

``analytics_serve`` caches an :class:`repro_torch.core.analytics.AnalyticsEngine`
(the flattened index plus its LCP array, in the JAX package's npz layout):
normalize the cache path (``np.savez`` appends ``.npz``, so the existence
check must too), load and validate it against the requested dataset if
the file exists, otherwise build once and save.  Sharded archives
(ROADMAP A12) and the archive migration (A11) are later slices.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable

from repro_torch.core.query import npz_path
from repro_torch.data.strings import dataset


def normalize_npz(path: str | None) -> str | None:
    """The path ``np.savez_compressed`` will actually write."""
    return None if path is None else npz_path(path)


def will_load(index_path: str | None) -> bool:
    """True when :func:`load_or_build` would take the cache path."""
    path = normalize_npz(index_path)
    return path is not None and os.path.exists(path)


def load_or_build(index_path: str | None, dataset_name: str, n: int,
                  seed: int, *, load: Callable, build: Callable,
                  dev_of: Callable = lambda obj: obj):
    """Load ``load(path)`` from the npz cache, else ``build(s, alphabet)``
    and save.  ``dev_of`` extracts the underlying DeviceIndex (``eng.dev``
    for analytics_serve) for validation and string recovery.  Returns
    ``(obj, s, alphabet, t_seconds)``.

    A cache hit serves whatever string the npz was built from: the
    alphabet base must match, an ``n`` mismatch prints a notice, and
    ``seed`` is not validated (the string comes from the npz itself)."""
    path = normalize_npz(index_path)
    t0 = time.perf_counter()
    if will_load(index_path):
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

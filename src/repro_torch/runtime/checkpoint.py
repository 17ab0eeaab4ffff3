"""Training-state checkpoints (the port of ``repro.runtime.checkpoint``).

The JAX package's file layout exactly: one ``.npz`` whose keys are the
leaves' paths joined with ``/`` (a dictionary key, a sequence index or a
named tuple's field name: ``0/embed``, ``0/layers/attn/wq``, ``1/m/…``,
``1/step`` for ``(params, AdamWState)``), plus a ``__meta__`` uint8 JSON
header holding ``step`` and the caller's meta, written to a temporary file
and committed by ``os.replace``, so a process that dies mid-write leaves
the latest checkpoint whole.  A checkpoint either package writes restores
in the other.  The ERA construction checkpoints are
:mod:`repro_torch.runtime.scheduler`'s.

A bfloat16 leaf is written as its bit pattern in a numpy ``|V2`` array
(numpy has no bfloat16), the array JAX's ``np.asarray`` of a bfloat16
leaf gives ``np.savez``, so both packages write the same bytes.  Restoring
departs from JAX's on purpose: where JAX returns the raw ``|V2`` array,
the port reinterprets it as its bfloat16 target leaf, and refuses a raw
array whose target is not bfloat16 or whose item is not 2 bytes.
"""

from __future__ import annotations

import json
import os
import re
import tempfile

import numpy as np
import torch

from repro_torch import pytree


def _key(path: tuple) -> str:
    return "/".join(path)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view("V2")
        return leaf.numpy()
    return np.asarray(leaf)


def _to_tensor(key: str, arr: np.ndarray, leaf) -> torch.Tensor:
    if arr.dtype.kind != "V":
        return torch.from_numpy(arr)
    if not (isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
            and arr.dtype.itemsize == 2):
        raise ValueError(f"{key}: raw {arr.dtype.str} array needs a "
                         f"bfloat16 target, not {getattr(leaf, 'dtype', leaf)}")
    return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)


def save(path: str, tree, *, step: int | None = None, meta: dict | None = None):
    """Atomic checkpoint write (tmp file + rename)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {_key(p): _to_numpy(leaf)
               for p, leaf in pytree.leaves_with_paths(tree)}
    header = {"step": step, **(meta or {})}
    payload["__meta__"] = np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **payload)  # file handle: numpy won't append ".npz"
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def restore(path: str, target_tree):
    """Restore into the structure of ``target_tree``: each array as saved
    (its dtype; a ``|V2`` array as its bfloat16 target), on the device of
    its target leaf (the CPU for a leaf without one, such as a numpy
    array).  Raises ``KeyError`` for a key the file lacks and
    ``ValueError`` for a shape that differs, with the JAX package's
    messages, and ``ValueError`` for a raw ``|V…`` array whose target is
    not bfloat16 or whose item is not 2 bytes."""
    out = []
    with np.load(path, allow_pickle=False) as data:
        meta = (json.loads(bytes(data["__meta__"]).decode())
                if "__meta__" in data else {})
        for pathk, leaf in pytree.leaves_with_paths(target_tree):
            key = _key(pathk)
            if key not in data:
                raise KeyError(f"checkpoint missing key {key!r}")
            arr = data[key]
            want = tuple(leaf.shape)
            if tuple(arr.shape) != want:
                raise ValueError(f"{key}: shape {arr.shape} != expected {want}")
            out.append(_to_tensor(key, arr, leaf).to(
                leaf.device if isinstance(leaf, torch.Tensor) else "cpu"))
    return pytree.unflatten_like(target_tree, out), meta


def latest_step_path(ckpt_dir: str, prefix: str = "step_") -> str | None:
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_step = None, -1
    for f in os.listdir(ckpt_dir):
        m = re.fullmatch(rf"{prefix}(\d+)\.npz", f)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(ckpt_dir, f), int(m.group(1))
    return best

"""Nested containers of tensors, flattened in ``jax.tree``'s order.

The optimizer state and the training checkpoints are trees: dictionaries
(flattened in sorted key order, as ``jax.tree`` flattens them), named
tuples (by field), tuples and lists (by index), with tensors or arrays at
the leaves; ``None`` is an empty subtree.  A leaf's path is the tuple of
its keys as strings, as ``repro.runtime.checkpoint`` joins them: a
dictionary key, a sequence index or a named tuple's field name.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def leaves_with_paths(tree: Any, path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """(path, leaf) pairs in flattening order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], path + (str(k),))
    elif _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            yield from leaves_with_paths(v, path + (name,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, path + (str(i),))
    else:
        yield path, tree


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leafwise to ``tree`` and the trees of the same
    structure in ``rest``; the result has ``tree``'s structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten_like(tree: Any, new_leaves) -> Any:
    """A tree of ``tree``'s structure holding ``new_leaves`` in flattening
    order."""
    it = iter(new_leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out

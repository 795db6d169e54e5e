"""Flatten and rebuild trees of tensors in ``jax.tree.leaves`` order.

The port's parameters, optimizer state and train state are plain nests of
dicts, lists and tuples with tensors at the leaves, laid out as the JAX
package lays out its pytrees.  Everything that pairs leaves across two
trees (the optimizer's per-leaf state, checkpoint files, leaf paths)
walks them here, in the order JAX walks them: dict keys sorted, lists and
tuples in order, ``None`` an empty node.  So the DLRM tree flattens as
``bottom, proj, tables, top``, a QR pair as ``table_0, table_1``, and the
train state as ``opt, params, step``, as the reference's do.

The walks are module-level functions, not nested closures: a recursive
closure is a reference cycle, and it would keep the leaves it saw (up to a
whole parameter tree of device memory) alive until the cyclic garbage
collector ran.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

__all__ = ["flatten_with_path", "leaves", "unflatten", "tree_map"]


def _children(node):
    """(key, child) pairs of a container node, in JAX's order; None for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _flatten(node, path, out) -> None:
    if node is None:
        return
    kids = _children(node)
    if kids is None:
        out.append((path, node))
        return
    for k, child in kids:
        _flatten(child, path + (k,), out)


def flatten_with_path(tree) -> list[tuple[tuple, Any]]:
    """``(path, leaf)`` per leaf; a path is the tuple of dict keys and
    sequence indices from the root."""
    out: list = []
    _flatten(tree, (), out)
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def _build(node, it: Iterator):
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return type(node)(_build(child, it) for child in node)
    return next(it)


def unflatten(like, new_leaves) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` in leaf order
    (its dicts' keys in sorted order, as JAX rebuilds them)."""
    it = iter(new_leaves)
    out = _build(like, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable, tree):
    """``fn`` over the leaves of ``tree``, rebuilt in its structure."""
    return unflatten(tree, [fn(leaf) for leaf in leaves(tree)])

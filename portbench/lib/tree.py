"""Parameter trees as the models lay them out: dicts (keys in sorted
order), lists, tensor leaves; a leaf's path joins its keys with ``/``."""

from __future__ import annotations


def items(tree, path=""):
    """``(path, leaf)`` for every leaf, dict keys in sorted order; a dict
    with ``q`` and ``scale`` (an int8 table) is one leaf."""
    if isinstance(tree, dict) and not ("q" in tree and "scale" in tree):
        out = []
        for k in sorted(tree):
            out += items(tree[k], f"{path}/{k}" if path else str(k))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += items(v, f"{path}/{i}" if path else str(i))
        return out
    return [(path, tree)]


def tree_map(fn, tree):
    if isinstance(tree, dict) and not ("q" in tree and "scale" in tree):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def rebuild(like, values: dict, path=""):
    """A tree of ``like``'s structure whose leaves are ``values[path]``."""
    if isinstance(like, dict) and not ("q" in like and "scale" in like):
        return {k: rebuild(v, values, f"{path}/{k}" if path else str(k)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(rebuild(v, values, f"{path}/{i}" if path else str(i))
                          for i, v in enumerate(like))
    return values[path]

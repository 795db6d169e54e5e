"""The benchmark's parameters, made on the device from the seed in a few
large calls, in the tree layout the port's ``dlrm_init`` / ``dcn_init``
return: one ``torch.rand`` for every uniform leaf, one ``torch.randn`` for
every normal leaf, one ``torch.zeros`` for the rest, each leaf a view of
its buffer, scaled in place."""

from __future__ import annotations

import math
import zlib

import torch

from . import tree


def _insert(root: dict, path: str, value) -> None:
    keys = path.split("/")
    node = root
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def _listify(node):
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out


def make(layout: list, seed: int, device) -> dict:
    """``layout``: ``(path, shape, kind, scale)`` per leaf, ``kind`` one of
    ``uniform`` (``U(−scale, scale)``), ``normal`` (``scale · N(0, 1)``),
    ``zeros``.  Returns the tree, f32 on ``device``."""
    gen = torch.Generator(device=device).manual_seed(zlib.crc32(f"{seed}:params".encode()))
    totals = {"uniform": 0, "normal": 0, "zeros": 0}
    for _, shape, kind, _ in layout:
        totals[kind] += math.prod(shape)
    bufs = {"uniform": torch.rand(totals["uniform"], generator=gen, device=device),
            "normal": torch.randn(totals["normal"], generator=gen, device=device),
            "zeros": torch.zeros(totals["zeros"], device=device)}
    at = dict.fromkeys(totals, 0)
    root: dict = {}
    for path, shape, kind, scale in layout:
        n = math.prod(shape)
        leaf = bufs[kind][at[kind]:at[kind] + n].view(shape)
        at[kind] += n
        if kind == "uniform":
            leaf.mul_(2.0 * scale).sub_(scale)
        elif kind == "normal":
            leaf.mul_(scale)
        _insert(root, path, leaf)
    return _listify(root)


def fingerprint(params) -> list:
    """One f64 sum per leaf: equal trees read equal."""
    return [float(leaf.to(torch.float64).sum()) for _, leaf in tree.items(params)]

"""Post-training row-wise quantization of compositional embedding tables.

Each table row gets its own affine int8 code

    w ≈ scale * (q - zp)        q int8 in [-127, 127], zp int8, scale bf16

so a ``(rows, D)`` f32 table becomes ``D + 3`` bytes per row instead of
``4·D``.  The row range is widened to include 0 (which pins the zero point
into int8 range and keeps padding rows exact), the scale is rounded to
bf16 *before* quantizing (so decoding with the stored scale reproduces the
encoder's grid and the per-row error stays within ``scale / 2``), and the
zero point is an integer.  Rounding is half-to-even throughout, exactly as
in the reference, so ``q``/``scale``/``zp`` match it bit for bit.

A quantized table is a plain dict ``{"q": int8 (rows, D), "scale": bf16
(rows, 1), "zp": int8 (rows, 1)}``.  ``mode="bf16"`` casts matching leaves
to bf16 with no layout change.
"""

from __future__ import annotations

import math
import re
from typing import Sequence

import torch

from ..core.compositional import is_quantized_table, table_rows

__all__ = ["MODES", "TABLE_PATTERN", "quantize_table", "dequantize_rows", "dequantize_table",
           "quantize_params", "paths_and_leaves", "table_bytes", "table_shapes",
           "memory_report", "row_bytes"]

MODES = ("f32", "bf16", "int8")

# embedding and hash tables are the memory-dominant leaves quantization exists for
TABLE_PATTERN = r"(^|/)(embed\w*|wte|tok_emb|tables?)(/|$)|(^|/)table_\d+($|/)"

# q and zp live in [-QMAX, QMAX]; the grid spans 2*QMAX - 2 steps so that
# rounding the zero point to an integer can never push a code out of range.
_QMAX = 127
_STEPS = 2 * _QMAX - 2  # 252


def row_bytes(dim: int, mode: str = "int8") -> int:
    """Bytes per stored table row of width ``dim`` under ``mode``: int8
    rows carry ``dim`` q bytes + 2 (bf16 scale) + 1 (int8 zp)."""
    if mode not in MODES:
        raise ValueError(f"unknown quantization mode {mode!r}; expected one of {MODES}")
    return {"f32": 4 * dim, "bf16": 2 * dim, "int8": dim + 3}[mode]


def quantize_table(w) -> dict:
    """Row-wise affine int8 quantization of a ``(rows, D)`` table, on the
    table's own device."""
    if w.dim() != 2:
        raise ValueError(f"quantize_table expects (rows, D), got {tuple(w.shape)}")
    w32 = w.to(torch.float32)
    lo = torch.clamp(w32.amin(dim=1, keepdim=True), max=0.0)
    hi = torch.clamp(w32.amax(dim=1, keepdim=True), min=0.0)
    scale = torch.clamp((hi - lo) / _STEPS, min=torch.finfo(torch.float32).tiny)
    # round-trip through bf16 FIRST: the encoder and decoder must agree on
    # the grid, otherwise the stored-scale mismatch adds |w| * 2^-9 error
    scale = scale.to(torch.bfloat16)
    s32 = scale.to(torch.float32)
    zp = torch.round(-(_QMAX - 1) - lo / s32)  # in [-(QMAX-1), QMAX-1]
    q = torch.clamp(torch.round(w32 / s32 + zp), -_QMAX, _QMAX)
    return {"q": q.to(torch.int8), "scale": scale, "zp": zp.to(torch.int8)}


def dequantize_rows(qt: dict, idx):
    """Gather and dequantize rows ``idx`` of a quantized table (f32 out).

    Only the gathered rows are widened: the f32 table never materialises
    (the point of serving quantized)."""
    return table_rows(qt, idx)


def dequantize_table(qt: dict):
    """Full-table dequantization (tests / error-bound checks only)."""
    return ((qt["q"].to(torch.float32) - qt["zp"].to(torch.float32))
            * qt["scale"].to(torch.float32))


def _match(path: str, patterns: Sequence[str]) -> bool:
    return any(re.search(p, path) for p in patterns)


def _walk(tree, path=""):
    """(path, leaf) pairs in the reference's leaf order (dict keys sorted),
    treating quantized-table dicts as single leaves."""
    if is_quantized_table(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}/{i}" if path else str(i))
    else:
        yield path, tree


def paths_and_leaves(params) -> list:
    """(path, leaf) pairs treating quantized-table dicts as single leaves —
    a quantized leaf keeps the path of the f32 leaf it replaced, so pairing
    the two trees by path pairs original and quantized tables exactly."""
    return list(_walk(params))


def _map(tree, fn, path=""):
    """Rebuild ``tree`` with ``fn(path, leaf)`` at every tensor leaf."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, f"{path}/{k}" if path else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, f"{path}/{i}" if path else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def quantize_params(params, mode: str = "int8",
                    patterns: Sequence[str] = (TABLE_PATTERN,)):
    """Quantize every rank-2 table leaf of a param tree for serving.

    Leaves whose path matches ``patterns`` are replaced by quantized-table
    dicts (``int8``) or cast to bf16 (``bf16``); everything else is
    returned untouched.  ``mode="f32"`` is the identity.
    """
    if mode not in MODES:
        raise ValueError(f"unknown quantization mode {mode!r}; expected one of {MODES}")
    if mode == "f32":
        return params

    def one(path, leaf):
        if getattr(leaf, "ndim", 0) == 2 and _match(path, patterns):
            return quantize_table(leaf) if mode == "int8" else leaf.to(torch.bfloat16)
        return leaf

    return _map(params, one)


def _leaf_bytes(leaf) -> int:
    if is_quantized_table(leaf):
        return sum(_leaf_bytes(v) for v in leaf.values())
    return int(math.prod(leaf.shape)) * leaf.element_size()


def table_bytes(params, patterns: Sequence[str] = (TABLE_PATTERN,)) -> int:
    """Total bytes of the table leaves (quantized dicts count q+scale+zp)."""
    return sum(_leaf_bytes(leaf) for path, leaf in _walk(params)
               if is_quantized_table(leaf) or _match(path, patterns))


def table_shapes(params, patterns: Sequence[str] = (TABLE_PATTERN,)
                 ) -> list[tuple[str, int, int]]:
    """``(path, rows, width)`` per table leaf (quantized dicts report their
    ``q`` shape)."""
    out = []
    for path, leaf in _walk(params):
        if is_quantized_table(leaf):
            out.append((path, int(leaf["q"].shape[0]), int(leaf["q"].shape[1])))
        elif getattr(leaf, "ndim", 0) == 2 and _match(path, patterns):
            out.append((path, int(leaf.shape[0]), int(leaf.shape[1])))
    return out


def memory_report(params, qparams, placement=None) -> dict:
    """Bytes vs f32 for the table leaves: the number the paper and the
    serving stack exist to shrink.

    With a ``placement`` (``dist.serve_placement.ServePlacement``) the
    report adds the sharded serving view: per-rank table bytes under that
    placement (replicated sub-tables in full, row-sharded ones their padded
    1/N block) and the per-rank ratio against an even f32 split."""
    base = table_bytes(params)
    quant = table_bytes(qparams)
    report = {"f32_table_bytes": base, "quant_table_bytes": quant,
              "ratio": quant / base if base else 1.0,
              "table_dims": sorted({w for _, _, w in table_shapes(params)}),
              "model_bytes_f32": sum(_leaf_bytes(leaf) for _, leaf in _walk(params)),
              "model_bytes_quant": sum(_leaf_bytes(leaf) for _, leaf in _walk(qparams))}
    if placement is not None:
        n = placement.n_devices
        per_dev = placement.bytes_per_device()
        report["placement"] = {"n_devices": n, "table_bytes_per_device": per_dev,
                               "replicated_bytes": placement.replicated_bytes(),
                               "pad_bytes": placement.pad_bytes(),
                               "ratio_per_device": (per_dev / (base / n)) if base else 1.0}
    return report

"""Quotient–remainder tables (Shi et al. 2020, Algorithm 2) and the int8
row rule, plain.

A table of ``S`` categories with ``c`` collisions is a remainder table of
``m = ceil(S / c)`` rows, read at ``x mod m``, and a quotient table of
``ceil(S / m)`` rows, read at ``x div m``; ``mult`` multiplies the two
rows, ``add`` adds them.  A table of at most ``max(threshold, 1)``
categories stays one full table.

The int8 rule is a frozen copy of the serving rule: per row, the range
widened to hold 0, ``scale = (hi − lo) / 252`` rounded to bf16 first,
``zp = round(−126 − lo / scale)``, ``q = clamp(round(w / scale + zp),
−127, 127)``, rounding half to even; a row reads back as
``(q − zp) · scale`` in f32.
"""

from __future__ import annotations

import torch

__all__ = ["table_shapes", "quantize_rows", "lookup", "embed"]

_QMAX = 127
_STEPS = 2 * _QMAX - 2


def table_shapes(size: int, dim: int, emb: dict) -> dict:
    """``{leaf name: (rows, dim)}`` of one feature's table(s)."""
    if emb["kind"] != "qr":
        raise ValueError(f"the reference knows QR tables only, not {emb['kind']!r}")
    if size <= max(emb.get("threshold", 0), 1):
        return {"table": (size, dim)}
    m = -(-size // max(1, emb["num_collisions"]))
    return {"table_0": (m, dim), "table_1": (-(-size // m), dim)}


def quantize_rows(w: torch.Tensor) -> dict:
    """The int8 rule over the rows of ``w`` ``(rows, D)``."""
    w32 = w.to(torch.float32)
    lo = torch.clamp(w32.amin(dim=1, keepdim=True), max=0.0)
    hi = torch.clamp(w32.amax(dim=1, keepdim=True), min=0.0)
    scale = torch.clamp((hi - lo) / _STEPS, min=torch.finfo(torch.float32).tiny)
    scale = scale.to(torch.bfloat16)
    s32 = scale.to(torch.float32)
    zp = torch.round(-(_QMAX - 1) - lo / s32)
    q = torch.clamp(torch.round(w32 / s32 + zp), -_QMAX, _QMAX)
    return {"q": q.to(torch.int8), "scale": scale, "zp": zp.to(torch.int8)}


def _rows(table, idx):
    idx = idx.long()
    if isinstance(table, dict):
        q = table["q"][idx].to(torch.float32)
        return (q - table["zp"][idx].to(torch.float32)) * table["scale"][idx].to(torch.float32)
    return table[idx]


def lookup(tables: dict, ids: torch.Tensor, op: str) -> torch.Tensor:
    """One feature's rows for ``ids``: ``tables`` holds ``table`` or the
    pair ``table_0`` / ``table_1``, each f32 or int8 (``quantize_rows``)."""
    if "table" in tables:
        return _rows(tables["table"], ids)
    t0 = tables["table_0"]
    m = (t0["q"] if isinstance(t0, dict) else t0).shape[0]
    a = _rows(t0, torch.remainder(ids, m))
    b = _rows(tables["table_1"], torch.div(ids, m, rounding_mode="floor"))
    if op == "mult":
        return a * b
    if op == "add":
        return a + b
    raise ValueError(f"op {op!r}")


def embed(tables: list, sparse: torch.Tensor, op: str) -> list:
    """Every feature's rows: ``sparse`` ``(B, F)`` → F tensors ``(B, D)``."""
    return [lookup(t, sparse[:, i], op) for i, t in enumerate(tables)]

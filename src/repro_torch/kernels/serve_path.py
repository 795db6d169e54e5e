"""Fused serving lookup: gather → int8 dequant → mult/add combine → masked
f32 bag pool → one rounding → optional projection, for one categorical
feature (``fused_serve_pool``) or for every feature of a wave in one launch
(``fused_serve_pool_grouped``).

Kernel: ``csrc/grouped_lookup.cu`` (CUDA C++ for sm_90a), replacing the
Pallas TPU kernel ``repro/kernels/serve_path.py::fused_serve_pool``; both
entries launch it, the per-table one with a single table and pre-split ids.

Bound on the card: memory.  The work is a scattered gather of short rows
(16 bytes for an int8 row at D=16, plus 3 bytes of scale and zero point)
with ~2 flops per byte, and at a wave's size the floor is one launch plus
a few dependent memory round trips.  The grouped entry pays that floor once
per wave instead of once per table, splits the QR ids and reads the mask
in place inside the kernel.  Where the TPU wrapper rebuilt a ``(rows, 2)``
f32 metadata table from the whole quantized table on every call, the
kernel reads the stored bf16 scale and int8 zero point directly.

For CPU tensors the wrappers return the plain versions
(``kernels/ref.py``); for CUDA tensors they launch the kernel or raise.
``fused_serve_pool.launches`` counts the launches of both entries.
"""

from __future__ import annotations

from . import _build, grouped_lookup, ref

__all__ = ["fused_serve_pool", "fused_serve_pool_grouped"]


def fused_serve_pool(idx_a, mask, w_a, idx_b=None, w_b=None, scale_a=None,
                     zp_a=None, scale_b=None, zp_b=None, proj=None, *,
                     op: str = "mult"):
    """Fused bag lookup of one table.

    Args:
      idx_a: int ``(B, L)`` row ids into ``w_a`` (pre-folded: the remainder
        ``i % m`` of a QR pair, ``i mod m`` for a hash table).
      mask: ``(B, L)`` pool weights (0 drops the slot; an all-zero row pools
        to the exact zero vector).  ``L = 0`` pools to zeros.
      w_a: ``(rows, d)`` table — f32, bf16, or int8 with ``scale_a``/``zp_a``.
      idx_b, w_b: optional quotient side of a QR pair, combined by ``op``.
      scale_*, zp_*: bf16 / int8 ``(rows, 1)`` of an int8 table (both
        tables of a pair quantize together).
      proj: optional ``(d, D)`` projection applied to the pooled bag.
    Returns ``(B, D)``: f32 when quantized or projected, else the table dtype.
    """
    quant = scale_a is not None
    has_b = idx_b is not None
    if has_b != (w_b is not None) or (quant and has_b) != (scale_b is not None) \
            or quant != (zp_a is not None) or (scale_b is None) != (zp_b is None):
        raise ValueError("QR pair / quant scale+zp operands must come in pairs")
    if has_b and op not in ("mult", "add"):
        raise ValueError(f"op={op!r}: the fused kernel combines with mult or add")
    operands = (idx_a, mask, w_a, idx_b, w_b, scale_a, zp_a, scale_b, zp_b, proj)
    if _build.launch_device(*operands) is None:
        return ref.fused_serve_pool(*operands, op=op)
    if mask.dim() != 2 or idx_a.shape != mask.shape:
        raise ValueError(f"fused_serve_pool: ids {tuple(idx_a.shape)} and mask "
                         f"{tuple(mask.shape)} are not one (B, L)")
    table = ref.GroupTable(w_a, w_b, scale_a, zp_a, scale_b, zp_b, 0, op, proj)
    out = grouped_lookup.launch(fused_serve_pool, "fused_serve_pool", idx_a[:, None],
                                mask[:, None], [table], bag=True,
                                idx_b=None if idx_b is None else idx_b[:, None])
    return out[:, 0]


def fused_serve_pool_grouped(idx, mask, tables):
    """K4 over every table of a wave in one launch.

    ``idx``: int ``(B, T, L)`` raw ids, non-negative and below each
    table's size; ``mask``: ``(B, T, L)`` pool weights, or None for weight
    1; ``tables``: T ``ref.GroupTable``s, each split (QR pair) or folded
    (hash table) by its ``m`` inside the kernel.  Every table must give
    the same output width and dtype.  Returns ``(B, T, D)``.
    """
    if _build.launch_device(idx, mask, *(x for t in tables for x in t.tensors())) is None:
        return ref.fused_serve_pool_grouped(idx, mask, tables)
    return grouped_lookup.launch(fused_serve_pool, "fused_serve_pool_grouped", idx, mask,
                                 tables, bag=True)


fused_serve_pool.launches = 0

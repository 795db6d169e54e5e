"""Fused serving lookup for one categorical feature: gather → int8 dequant →
mult/add combine → masked f32 bag pool → one rounding → optional projection.

Kernel: ``csrc/serve_path.cu`` (CUDA C++ for sm_90a), replacing the Pallas
TPU kernel ``repro/kernels/serve_path.py::fused_serve_pool``.

Bound on the card: memory.  The work is a scattered gather of short rows
(16 bytes for an int8 row at D=16, plus 3 bytes of scale and zero point)
with ~2 flops per byte, so the least time is the bytes moved over the
card's memory rate.  The design reads every id, mask weight, row and
scale/zp once, keeps the bag sum in f32 registers, and writes one output
row per bag.  Where the TPU wrapper rebuilt a ``(rows, 2)`` f32 metadata
table from the whole quantized table on every call, the kernel reads the
stored bf16 scale and int8 zero point directly, so a call costs nothing
table-wide.

For CPU tensors the wrapper returns the plain version
(``kernels/ref.py``); for CUDA tensors it launches the kernel or raises.
``fused_serve_pool.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import _build, ref

__all__ = ["fused_serve_pool"]

_TABLE_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _ptr(t):
    return None if t is None else t.data_ptr()


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"fused_serve_pool: {what}")


def fused_serve_pool(idx_a, mask, w_a, idx_b=None, w_b=None, scale_a=None,
                     zp_a=None, scale_b=None, zp_b=None, proj=None, *,
                     op: str = "mult"):
    """Fused bag lookup.

    Args:
      idx_a: int ``(B, L)`` row ids into ``w_a`` (pre-folded: the remainder
        ``i % m`` of a QR pair, ``i mod m`` for a hash table).
      mask: ``(B, L)`` pool weights (0 drops the slot; an all-zero row pools
        to the exact zero vector).  ``L = 0`` pads to one masked slot.
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
    idx_a, idx_b, mask = ref.pad_empty_wave(idx_a, idx_b, mask)
    operands = (idx_a, mask, w_a, idx_b, w_b, scale_a, zp_a, scale_b, zp_b, proj)
    device = _build.launch_device(*operands)
    if device is None:
        return ref.fused_serve_pool(idx_a, mask, w_a, idx_b, w_b, scale_a, zp_a,
                                    scale_b, zp_b, proj, op=op)

    b, l = mask.shape
    d = w_a.shape[1]
    _require(w_a.dtype in _TABLE_TYPES, f"table dtype {w_a.dtype} not f32/bf16/int8")
    _require(quant == (w_a.dtype == torch.int8), "int8 tables need scale and zp, "
             "dense tables take neither")
    idx_a = idx_a.to(torch.int32).contiguous()
    mask = mask.to(torch.float32).contiguous()
    _require(idx_a.shape == (b, l), f"idx_a {tuple(idx_a.shape)} != mask {(b, l)}")
    tables = [(w_a, scale_a, zp_a)]
    if has_b:
        idx_b = idx_b.to(torch.int32).contiguous()
        _require(idx_b.shape == (b, l), f"idx_b {tuple(idx_b.shape)} != mask {(b, l)}")
        _require(w_b.dtype == w_a.dtype and w_b.shape[1] == d,
                 "both tables of a pair share dtype and width")
        tables.append((w_b, scale_b, zp_b))
    for w, scale, zp in tables:
        _require(w.dim() == 2 and w.is_contiguous(), "tables are contiguous (rows, d)")
        if quant:
            _require(scale.dtype == torch.bfloat16 and zp.dtype == torch.int8,
                     "scale is bf16 and zp int8")
            _require(scale.shape == (w.shape[0], 1) and zp.shape == (w.shape[0], 1)
                     and scale.is_contiguous() and zp.is_contiguous(),
                     "scale and zp are contiguous (rows, 1)")
    d_out = d
    if proj is not None:
        _require(proj.dim() == 2 and proj.shape[0] == d, f"proj {tuple(proj.shape)} "
                 f"does not map width {d}")
        proj = proj.to(torch.float32).contiguous()
        d_out = proj.shape[1]
        tx = min(32, 1 << max(0, (d - 1).bit_length()))   # threads per bag
        smem = 4 * (d * d_out + (64 // tx) * d)            # proj + pooled bags
        _require(smem <= 232448, f"proj {d}x{d_out} exceeds a block's shared memory")
    out_dtype = torch.float32 if (quant or proj is not None) else w_a.dtype
    out = torch.empty((b, d_out), dtype=out_dtype, device=device)
    if b == 0:
        return out
    code = _build.library("serve_path").fused_serve_pool(
        _ptr(idx_a), _ptr(idx_b), _ptr(mask), _ptr(w_a), _ptr(w_b),
        _ptr(scale_a), _ptr(zp_a), _ptr(scale_b), _ptr(zp_b), _ptr(proj),
        _ptr(out), b, l, d, d_out, _TABLE_TYPES[w_a.dtype], int(has_b),
        int(op == "mult"), int(proj is not None),
        torch.cuda.current_stream(device).cuda_stream)
    _build.check("serve_path", code, "fused_serve_pool launch")
    fused_serve_pool.launches += 1
    return out


fused_serve_pool.launches = 0

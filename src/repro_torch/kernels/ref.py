"""Plain PyTorch versions of the ported kernels.

Each function computes what its kernel computes, with ordinary tensor
operations, and is the kernel's ground truth: the wrappers take it for
CPU tensors, the CPU tests hold it against the JAX package, and
``chip_smoke.py`` holds each kernel against it on the card.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["qr_gather", "qr_gather_quant", "qr_embedding_bag", "fused_serve_pool",
           "dot_interaction", "pad_empty_wave"]


def pad_empty_wave(idx_a, idx_b, mask):
    """An all-empty wave (``L = 0``) becomes one masked slot per bag, as
    the engine's ``Lb >= 1`` floor does; other waves pass through."""
    if mask.shape[1] > 0:
        return idx_a, idx_b, mask
    b, dev = mask.shape[0], mask.device
    zeros = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    return (zeros, None if idx_b is None else zeros,
            torch.zeros((b, 1), dtype=mask.dtype, device=dev))


def _rows(w, scale, zp, idx):
    """f32 rows of a dense table, or dequantized ``(q - zp) * scale`` rows."""
    idx = idx.long()
    r = w[idx].to(torch.float32)
    if scale is not None:
        r = (r - zp[idx].to(torch.float32)) * scale[idx].to(torch.float32)
    return r


def _combine(a, b, op):
    return a * b if op == "mult" else a + b


def qr_gather(rem, quo, w_rem, w_quo, *, op: str = "mult"):
    """``w_rem[rem] op w_quo[quo]`` for ``(N,)`` ids: both rows widen to
    f32 (exact for bf16), combine in f32, one cast to the table dtype."""
    return _combine(_rows(w_rem, None, None, rem), _rows(w_quo, None, None, quo),
                    op).to(w_rem.dtype)


def qr_gather_quant(rem, quo, q_rem, q_quo, scale_rem, zp_rem, scale_quo, zp_quo, *,
                    op: str = "mult"):
    """The int8 QR pair's lookup: each gathered row dequantizes as
    ``(q - zp) * scale`` in f32 from its stored bf16 scale and int8 zero
    point, the two rows combine in f32, and the output is f32."""
    return _combine(_rows(q_rem, scale_rem, zp_rem, rem),
                    _rows(q_quo, scale_quo, zp_quo, quo), op)


def qr_embedding_bag(rem, quo, mask, w_rem, w_quo, *, op: str = "mult"):
    """``out[b] = sum_l mask[b, l] * (w_rem[rem[b, l]] op w_quo[quo[b, l]])``
    over ``(B, L)`` ids.  The mask is rounded to the table dtype first (a
    fractional weight on a bf16 table multiplies as bf16), each slot's
    contribution ``(a op b) * w`` and the bag sum are f32, and the pooled
    bag is cast once to the table dtype.  ``L = 0`` pools to zeros."""
    w = mask.to(w_rem.dtype).to(torch.float32)[..., None]
    rows = _combine(_rows(w_rem, None, None, rem), _rows(w_quo, None, None, quo), op)
    return torch.sum(rows * w, dim=1, dtype=torch.float32).to(w_rem.dtype)


def fused_serve_pool(idx_a, mask, w_a, idx_b=None, w_b=None, scale_a=None,
                     zp_a=None, scale_b=None, zp_b=None, proj=None, *,
                     op: str = "mult"):
    """Gather (+dequant) → combine → masked f32 sum-pool → one rounding to
    the pool dtype → optional f32 projection.

    ``idx_a``/``idx_b`` are ``(B, L)`` row ids (already split for a QR
    pair); ``scale_*`` (bf16) and ``zp_*`` (int8) are the ``(rows, 1)``
    columns of a row-quantized table.  The combine runs in f32 even for
    bf16 tables (bf16 rows are exact in f32), so the only dtype-dependent
    rounding is the single cast of the pooled bag.  The pool dtype is f32
    for quantized tables and the table dtype otherwise; the output is f32
    when quantized or projected.
    """
    quant = scale_a is not None
    idx_a, idx_b, mask = pad_empty_wave(idx_a, idx_b, mask)
    row = _rows(w_a, scale_a, zp_a, idx_a)
    if idx_b is not None:
        row = _combine(row, _rows(w_b, scale_b, zp_b, idx_b), op)
    pooled = torch.sum(row * mask[..., None].to(torch.float32), dim=1,
                       dtype=torch.float32)
    pooled = pooled.to(torch.float32 if quant else w_a.dtype)
    if proj is None:
        return pooled
    return pooled.to(torch.float32) @ proj.to(torch.float32)


def dot_interaction(x):
    """Packed strict lower triangle of ``X·Xᵀ`` per example, accumulated in
    f32, in ``np.tril_indices(F, k=-1)`` order, cast to ``x``'s dtype."""
    x32 = x.to(torch.float32)
    scores = torch.bmm(x32, x32.transpose(1, 2))
    i, j = np.tril_indices(x.shape[1], k=-1)
    i = torch.as_tensor(i, device=x.device)
    j = torch.as_tensor(j, device=x.device)
    return scores[:, i, j].to(x.dtype)

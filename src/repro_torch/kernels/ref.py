"""Plain PyTorch versions of the ported kernels.

Each function computes what its kernel computes, with ordinary tensor
operations, and is the kernel's ground truth: the wrappers take it for
CPU tensors, the CPU tests hold it against the JAX package, and
``chip_smoke.py`` holds each kernel against it on the card.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = ["qr_gather", "qr_gather_quant", "qr_embedding_bag", "fused_serve_pool",
           "dot_interaction", "pad_empty_wave", "GroupTable", "pool_out_dtype",
           "fused_serve_pool_grouped", "qr_gather_grouped", "qr_gather_quant_grouped",
           "qr_embedding_bag_raw", "dot_interaction_concat", "qr_pairs_backward"]


class GroupTable(NamedTuple):
    """One table of a grouped lookup, as raw tensors.

    ``w_a`` alone is a full table (``m = 0``: ids taken as given) or a
    hash table (ids folded ``i % m``).  With ``w_b`` it is a QR pair: the
    remainder table ``w_a`` of ``m`` rows and the quotient table ``w_b``,
    ids split ``(i % m, i // m)`` and the rows combined by ``op``.  An int8
    table carries its bf16 ``scale`` and int8 ``zp`` ``(rows, 1)`` columns;
    ``proj`` is an optional ``(d, D)`` projection of the pooled bag.
    """
    w_a: torch.Tensor
    w_b: Optional[torch.Tensor] = None
    scale_a: Optional[torch.Tensor] = None
    zp_a: Optional[torch.Tensor] = None
    scale_b: Optional[torch.Tensor] = None
    zp_b: Optional[torch.Tensor] = None
    m: int = 0
    op: str = "mult"
    proj: Optional[torch.Tensor] = None

    def tensors(self) -> list:
        return [x for x in self if isinstance(x, torch.Tensor)]


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


def pool_out_dtype(table: GroupTable) -> torch.dtype:
    """``fused_serve_pool``'s output dtype for one table: f32 when
    quantized or projected, else the table dtype."""
    quant = table.scale_a is not None
    return torch.float32 if quant or table.proj is not None else table.w_a.dtype


def _split_ids(idx, table: GroupTable):
    """Raw ids → (rows of ``w_a``, rows of ``w_b`` or None)."""
    if table.w_b is not None:
        return idx % table.m, idx // table.m
    return (idx % table.m if table.m else idx), None


def fused_serve_pool_grouped(idx, mask, tables):
    """``fused_serve_pool`` of every table of a wave: ``idx``/``mask``
    ``(B, T, L)`` raw ids and weights (``mask=None``: every slot weighs 1),
    ``tables`` T ``GroupTable``s → ``(B, T, D)``.  Table t's ids split or
    fold by its ``m``, its bags pool as ``fused_serve_pool`` pools them, and
    the T features stack on dim 1."""
    if mask is None:
        mask = torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
    feats = []
    for t, tab in enumerate(tables):
        ia, ib = _split_ids(idx[:, t], tab)
        feats.append(fused_serve_pool(ia, mask[:, t], tab.w_a, ib, tab.w_b, tab.scale_a,
                                      tab.zp_a, tab.scale_b, tab.zp_b, tab.proj, op=tab.op))
    return torch.stack(feats, dim=1)


def _table_rows(ids, table):
    """Row ids as ``table[ids]`` reads them: int64, a negative id counted
    from the end."""
    ids = ids.long()
    return torch.where(ids < 0, ids + table.shape[0], ids)


def qr_pairs_backward(grads, rem, quo, tables, ops):
    """K6's function: the gradients of P QR pairs' tables (``tables``: 2P,
    remainder and quotient pair by pair) from their outputs' gradients
    ``grads`` (P ``(B, D)``), with ``rem`` / ``quo`` the P pairs' ``(B,)``
    row ids and ``ops`` their combines.  For ``mult`` each sample adds
    ``g * (the other table's row)`` to its row of each table, for ``add``
    ``g``; the products (bf16 widened exactly) and the sums are f32 (f64 for
    f64 tables: the oracle the card's checks hold K6 to), each row's terms
    added in sample order on the CPU (``index_add_``), and the sums rounded
    once to the tables' dtype.  Returns the 2P gradients as views of one
    flat buffer."""
    d = tables[0].shape[1]
    rows = [t.shape[0] for t in tables]
    acc = torch.promote_types(tables[0].dtype, torch.float32)
    flat = torch.zeros((sum(rows), d), dtype=acc, device=tables[0].device)
    sums = torch.split(flat, rows)
    for p, op in enumerate(ops):
        w_rem, w_quo = tables[2 * p], tables[2 * p + 1]
        r, q = _table_rows(rem[p], w_rem), _table_rows(quo[p], w_quo)
        g = grads[p].to(acc)
        sums[2 * p].index_add_(0, r, g * w_quo[q].to(acc) if op == "mult" else g)
        sums[2 * p + 1].index_add_(0, q, g * w_rem[r].to(acc) if op == "mult" else g)
    return list(torch.split(flat.to(tables[0].dtype), rows))


def qr_embedding_bag_raw(idx, mask, w_rem, w_quo, *, op: str = "mult"):
    """``qr_embedding_bag`` on one pair's raw ``(B, L)`` ids, split by the
    ``m`` rows of ``w_rem``."""
    m = w_rem.shape[0]
    return qr_embedding_bag(idx % m, idx // m, mask, w_rem, w_quo, op=op)


def qr_gather_grouped(idx, tables):
    """``qr_gather`` of every table: ``idx`` ``(B, T)`` raw ids, ``tables``
    T dense QR-pair ``GroupTable``s of one dtype → ``(B, T, D)`` in it."""
    return torch.stack([qr_gather(*_split_ids(idx[:, t], tab), tab.w_a, tab.w_b, op=tab.op)
                        for t, tab in enumerate(tables)], dim=1)


def qr_gather_quant_grouped(idx, tables):
    """``qr_gather_quant`` of every table: ``idx`` ``(B, T)`` raw ids,
    ``tables`` T int8 QR-pair ``GroupTable``s → f32 ``(B, T, D)``."""
    feats = []
    for t, tab in enumerate(tables):
        rem, quo = _split_ids(idx[:, t], tab)
        feats.append(qr_gather_quant(rem, quo, tab.w_a, tab.w_b, tab.scale_a, tab.zp_a,
                                     tab.scale_b, tab.zp_b, op=tab.op))
    return torch.stack(feats, dim=1)


@functools.lru_cache(maxsize=None)
def _tril(f: int, device: torch.device):
    """``np.tril_indices(f, k=-1)`` as tensors on ``device``, made once —
    outside inference mode, so a first call from the serving engine (which
    dispatches in it) caches tensors that autograd can still save."""
    i, j = np.tril_indices(f, k=-1)
    with torch.inference_mode(False):
        return torch.as_tensor(i, device=device), torch.as_tensor(j, device=device)


def dot_interaction(x):
    """Packed strict lower triangle of ``X·Xᵀ`` per example, accumulated in
    f32, in ``np.tril_indices(F, k=-1)`` order, cast to ``x``'s dtype."""
    x32 = x.to(torch.float32)
    scores = torch.bmm(x32, x32.transpose(1, 2))
    i, j = _tril(x.shape[1], x.device)
    return scores[:, i, j].to(x.dtype)


def dot_interaction_concat(z, feats):
    """The top MLP's input ``[z, tril(X·Xᵀ)]`` for ``X = [z; feats]``:
    ``z`` ``(B, D)`` and ``feats`` ``(B, T, D)`` of one dtype →
    ``(B, D + F(F-1)/2)`` with ``F = T + 1``."""
    return torch.cat([z, dot_interaction(torch.cat([z[:, None], feats], dim=1))], dim=-1)

"""Launch ``csrc/grouped_lookup.cu``: K4 ``fused_serve_pool``, K1
``qr_gather`` and K5 ``qr_gather_quant`` over a group of tables in one
launch.

The kernel wrappers (``serve_path.fused_serve_pool[_grouped]``,
``qr_gather.qr_gather[_grouped]``, ``qr_gather.qr_gather_quant[_grouped]``)
call ``launch`` for CUDA tensors.  It checks every table of the group in
one pass, packs one descriptor per table into the kernel's parameter,
picks each table's load width and the threads per bag, and launches on
the current stream.  It raises on what the kernel does not take; nothing
falls back.
"""

from __future__ import annotations

import array

import torch

from . import _build
from .ref import GroupTable, pool_out_dtype

__all__ = ["MAX_TABLES", "THREADS_PER_BAG", "launch"]

MAX_TABLES = 40          # kMaxTables of csrc/grouped_lookup.cu
# Threads per (bag, table) for rows of up to 64 bytes (D=16 in f32, bf16 or
# int8): of 1 to 16, 4 timed fastest on the H100 for a full serving wave and
# int8 scoring batch (4-byte loads of an int8 row) and for a full f32
# scoring batch (16-byte loads; PERF.md, the threads-per-bag sweep).
# Wider rows get one thread per 16 bytes, up to a warp.
THREADS_PER_BAG = 4
_NARROW_ROW = 64
_BLOCK = 64              # kThreads
_SMEM_MAX = 232448       # a block's shared memory on the H100
_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _require(cond: bool, name: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {what}")


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _vec_bytes(table: GroupTable, tpb: int) -> int:
    """The widest load (16 bytes down to one element) that divides the
    row, keeps every thread of a bag busy and is aligned on both tables."""
    elem = table.w_a.element_size()
    row = table.w_a.shape[1] * elem
    ptrs = [t.data_ptr() for t in (table.w_a, table.w_b) if t is not None]
    vb = 16
    while vb > elem and (row % vb or row // vb < tpb or any(p % vb for p in ptrs)):
        vb //= 2
    return vb


def _table_fault(tab: GroupTable, bag: bool, pre_split: bool):
    """What the kernel cannot take about one table, or None.  (Messages
    are built only on a fault: this runs for every table of every wave.)"""
    w, quant, pair = tab.w_a, tab.scale_a is not None, tab.w_b is not None
    if w.dtype not in _TYPES:
        return f"dtype {w.dtype} not f32/bf16/int8"
    if quant != (w.dtype == torch.int8) or (tab.zp_a is not None) != quant:
        return "int8 tables take scale and zp, dense tables neither"
    if not bag and not (pair and tab.proj is None):
        return "the one-hot kernel takes QR pairs (dense or int8) without projection"
    if not (tab.scale_b is not None) == (tab.zp_b is not None) == (quant and pair):
        return "an int8 pair's quotient table takes scale and zp, nothing else does"
    if pair and tab.op not in ("mult", "add"):
        return f"op={tab.op!r}: the kernel combines with mult or add"
    if tab.m < 0 or (pair and (tab.m > 0) == pre_split):
        return f"m={tab.m}: a pair of raw ids splits by m > 0, pre-split ids take m = 0"
    for x, scale, zp in ((w, tab.scale_a, tab.zp_a), (tab.w_b, tab.scale_b, tab.zp_b)):
        if x is None:
            continue
        if not (x.dim() == 2 and x.is_contiguous() and x.dtype == w.dtype
                and x.shape[1] == w.shape[1]):
            return "tables are contiguous (rows, d) of one dtype and width"
        if quant and not (scale.dtype == torch.bfloat16 and zp.dtype == torch.int8
                          and scale.shape == (x.shape[0], 1) and zp.shape == (x.shape[0], 1)
                          and scale.is_contiguous() and zp.is_contiguous()):
            return "scale is bf16 and zp int8, contiguous (rows, 1)"
    if tab.proj is not None and not (tab.proj.dim() == 2 and tab.proj.shape[0] == w.shape[1]):
        return f"proj {tuple(tab.proj.shape)} does not map width {w.shape[1]}"
    return None


def launch(counter, name, idx, mask, tables, *, bag: bool, idx_b=None):
    """One launch of the grouped kernel on the tensors' CUDA device, counted
    on ``counter.launches`` (none for an empty batch).

    ``idx``: int ``(B, T, L)`` raw ids (``(B, T)`` for the one-hot kernel,
    ``bag=False``); ``mask``: ``(B, T, L)`` weights or None (weight 1);
    ``tables``: T ``GroupTable``s.  ``idx_b`` carries pre-split quotient
    ids alike ``idx`` (the per-table entries, whose pairs take ``m = 0``).
    Returns ``(B, T, D)``: f32, or bf16 for unprojected dense bf16 tables
    (``ref.pool_out_dtype``).
    """
    _require(1 <= len(tables) <= MAX_TABLES, name,
             f"{len(tables)} tables; one launch takes 1..{MAX_TABLES}")
    _require(idx.dim() == (3 if bag else 2) and idx.shape[1] == len(tables), name,
             f"ids {tuple(idx.shape)} are not (B, T{', L' if bag else ''}) for "
             f"T={len(tables)} tables")
    idx = idx.to(torch.int32)
    if idx_b is not None:
        idx, idx_b = idx.contiguous(), idx_b.to(torch.int32).contiguous()
        _require(idx_b.shape == idx.shape, name, "pre-split ids differ in shape")
    if not bag:
        idx = idx[..., None]
        idx_b = None if idx_b is None else idx_b[..., None]
    b, n_tables, length = idx.shape
    if mask is not None:
        mask = mask.to(torch.float32)
        _require(mask.shape == idx.shape, name,
                 f"mask {tuple(mask.shape)} != ids {tuple(idx.shape)}")
    for t, tab in enumerate(tables):
        fault = _table_fault(tab, bag, idx_b is not None)
        if fault is not None:
            raise ValueError(f"{name}: table {t}: {fault}")
    widths = [tab.w_a.shape[1] if tab.proj is None else tab.proj.shape[1] for tab in tables]
    dtypes = {pool_out_dtype(tab) for tab in tables}
    _require(len(set(widths)) == 1 and len(dtypes) == 1, name,
             f"the tables' outputs differ: widths {sorted(set(widths))}, dtypes "
             f"{sorted(map(str, dtypes))}")
    d_out, out_dtype = widths[0], dtypes.pop()
    widest = max(tab.w_a.shape[1] * tab.w_a.element_size() for tab in tables)
    tpb = THREADS_PER_BAG if widest <= _NARROW_ROW else \
        max(THREADS_PER_BAG, min(32, _next_pow2(-(-widest // 16))))
    ptrs, ints, smem = [], [], 0
    keep = []   # converted projections: alive until the launch is queued
    for tab in tables:
        proj = tab.proj
        if proj is not None:
            proj = proj.to(torch.float32).contiguous()
            keep.append(proj)
            d = tab.w_a.shape[1]
            smem = max(smem, 4 * (d * d_out + (_BLOCK // tpb) * d))
        ptrs += [0 if x is None else x.data_ptr() for x in
                 (tab.w_a, tab.w_b, tab.scale_a, tab.zp_a, tab.scale_b, tab.zp_b, proj)]
        ints += [tab.m, tab.w_a.shape[1], _TYPES[tab.w_a.dtype], int(tab.op == "mult"),
                 _vec_bytes(tab, tpb)]
    _require(smem <= _SMEM_MAX, name, f"projections need {smem} B of shared memory "
             f"per block, over {_SMEM_MAX}")
    out = torch.empty((b, n_tables, d_out), dtype=out_dtype, device=idx.device)
    if b == 0:
        return out
    ms = (0, 0, 0) if mask is None else mask.stride()
    # the descriptors cross as flat host arrays (7 pointers, 5 ints per
    # table); the C entry copies them into the kernel's parameter
    ptrs, ints = array.array("Q", ptrs), array.array("i", ints)
    code = _build.library("grouped_lookup").grouped_lookup(
        ptrs.buffer_info()[0], ints.buffer_info()[0], n_tables,
        idx.data_ptr(), None if idx_b is None else idx_b.data_ptr(), *idx.stride(),
        None if mask is None else mask.data_ptr(), *ms, out.data_ptr(), b, length, d_out,
        int(out_dtype == torch.bfloat16), int(bag), tpb, smem,
        torch.cuda.current_stream(idx.device).cuda_stream)
    _build.check("grouped_lookup", code, f"{name} launch")
    counter.launches += 1
    return out

"""Launch ``csrc/grouped_lookup.cu``: K4 ``fused_serve_pool``, K3
``qr_embedding_bag``, K1 ``qr_gather`` and K5 ``qr_gather_quant`` over a
group of tables in one launch.

The kernel wrappers (``serve_path.fused_serve_pool[_grouped]``,
``qr_gather.qr_gather[_grouped]``, ``qr_gather.qr_gather_quant[_grouped]``)
call ``launch`` for CUDA tensors.  It checks every table of the group in
one pass, packs one descriptor per table into the kernel's parameter,
picks each table's load width and the threads per bag, and launches on
the current stream.  K3's wrappers (``embedding_bag.qr_embedding_bag``,
``embedding_bag.qr_embedding_bag_raw``) launch one dense QR pair through
``launch_bag_pair``, which checks only what that case needs.  Ids (int32
or int64) and the mask (f32 or bf16) are read in place; both raise on
what the kernel does not take, and nothing falls back.
"""

from __future__ import annotations

import array
import itertools

import torch

from ..obs.trace import span
from . import _build
from .ref import GroupTable, pool_out_dtype

__all__ = ["MAX_TABLES", "THREADS_PER_BAG", "WIDE_THREADS_PER_BAG", "launch", "launch_bag_pair"]

MAX_TABLES = 40          # kMaxTables of csrc/grouped_lookup.cu
# Threads per (bag, table) for rows of up to 64 bytes (D=16 in f32, bf16 or
# int8): of 1 to 16, 4 timed fastest on the H100 for a full serving wave and
# int8 scoring batch (4-byte loads of an int8 row) and for a full f32
# scoring batch (16-byte loads; PERF.md, the threads-per-bag sweep).
THREADS_PER_BAG = 4
# Wider rows get one thread per 16 bytes, up to WIDE_THREADS_PER_BAG: of 8,
# 16 and 32, 32 timed fastest for K3 at D=128 f32 (512-byte rows) at the
# kernel bench's shape and level with 16 on bags of L=32 over a table far
# above L2 (PERF.md, the K3 sweep).
WIDE_THREADS_PER_BAG = 32
_NARROW_ROW = 64
_BLOCK = 64              # kThreads
_SMEM_MAX = 232448       # a block's shared memory on the H100
_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_IDS = (torch.int32, torch.int64)
_MASKS = (torch.float32, torch.bfloat16)


def _require(cond: bool, name: str, what) -> None:
    """Raise ``ValueError`` unless ``cond``; ``what`` is the message or a
    function that builds it (built only on a fault: this runs per call)."""
    if not cond:
        raise ValueError(f"{name}: {what() if callable(what) else what}")


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _vec_bytes(w_a, w_b, tpb: int) -> int:
    """The widest load (16 bytes down to one element) that divides the
    row, keeps every thread of a bag busy and is aligned on both tables."""
    elem = w_a.element_size()
    row = w_a.shape[1] * elem
    ptrs = [t.data_ptr() for t in (w_a, w_b) if t is not None]
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


def proj_smem_bytes(d: int, d_out: int, tpb: int) -> int:
    """Shared memory a block takes to project a width-``d`` table to
    ``d_out``: the f32 ``(d, d_out)`` projection and the block's pooled
    bags, ``64 / tpb`` of them, each ``d`` f32 wide."""
    return 4 * (d * d_out + (_BLOCK // tpb) * d)


def _threads_per_bag(widest: int) -> int:
    """Threads per (bag, table) for a launch whose widest row has
    ``widest`` bytes."""
    if widest <= _NARROW_ROW:
        return THREADS_PER_BAG
    return max(THREADS_PER_BAG, min(WIDE_THREADS_PER_BAG, _next_pow2(-(-widest // 16))))


def launch(counter, name, idx, mask, tables, *, bag: bool, idx_b=None):
    """One launch of the grouped kernel on the tensors' CUDA device, counted
    on ``counter.launches`` (none for an empty batch).

    ``idx``: int ``(B, T, L)`` raw ids (``(B, T)`` for the one-hot kernel,
    ``bag=False``), read in place when int32 or int64 (other integer
    dtypes are converted to int32 first); ``mask``: ``(B, T, L)`` weights
    or None (weight 1), read in place when f32 or bf16 (other dtypes are
    converted to f32 first); ``tables``: T ``GroupTable``s.  ``idx_b``
    carries pre-split quotient ids alike ``idx`` (the per-table entries,
    whose pairs take ``m = 0``).  Returns
    ``(B, T, D)``: f32, or bf16 for unprojected dense bf16 tables
    (``ref.pool_out_dtype``).  Raises under grad mode when an operand
    requires grad (``_build.refuse_grad``): the kernel has no backward.
    The host side of the call (checks, packing, the C call) is one
    ``repro.launch`` span.
    """
    with span("repro.launch", kernel=name, ids=idx.numel()):
        _build.refuse_grad(name, itertools.chain((mask,), itertools.chain.from_iterable(
            tab.tensors() for tab in tables)))
        _require(1 <= len(tables) <= MAX_TABLES, name,
                 lambda: f"{len(tables)} tables; one launch takes 1..{MAX_TABLES}")
        _require(idx.dim() == (3 if bag else 2) and idx.shape[1] == len(tables), name,
                 lambda: f"ids {tuple(idx.shape)} are not (B, T{', L' if bag else ''}) for "
                         f"T={len(tables)} tables")
        if idx.dtype not in _IDS:
            idx = idx.to(torch.int32)
        if idx_b is not None:
            _require(idx_b.shape == idx.shape, name, "pre-split ids differ in shape")
            idx_b = idx_b.to(idx.dtype)
            if idx_b.stride() != idx.stride():   # both are read through one set of strides
                idx, idx_b = idx.contiguous(), idx_b.contiguous()
        if not bag:
            idx = idx[..., None]
            idx_b = None if idx_b is None else idx_b[..., None]
        b, n_tables, length = idx.shape
        if mask is not None:
            if mask.dtype not in _MASKS:
                mask = mask.to(torch.float32)
            _require(mask.shape == idx.shape, name,
                     lambda: f"mask {tuple(mask.shape)} != ids {tuple(idx.shape)}")
        for t, tab in enumerate(tables):
            fault = _table_fault(tab, bag, idx_b is not None)
            if fault is not None:
                raise ValueError(f"{name}: table {t}: {fault}")
        widths = [tab.w_a.shape[1] if tab.proj is None else tab.proj.shape[1] for tab in tables]
        dtypes = {pool_out_dtype(tab) for tab in tables}
        _require(len(set(widths)) == 1 and len(dtypes) == 1, name,
                 lambda: f"the tables' outputs differ: widths {sorted(set(widths))}, dtypes "
                         f"{sorted(map(str, dtypes))}")
        d_out, out_dtype = widths[0], dtypes.pop()
        widest = max(tab.w_a.shape[1] * tab.w_a.element_size() for tab in tables)
        tpb = _threads_per_bag(widest)
        ptrs, ints, smem = [], [], 0
        keep = []   # converted projections: alive until the launch is queued
        for tab in tables:
            proj = tab.proj
            if proj is not None:
                proj = proj.to(torch.float32).contiguous()
                keep.append(proj)
                d = tab.w_a.shape[1]
                smem = max(smem, proj_smem_bytes(d, d_out, tpb))
            ptrs += [0 if x is None else x.data_ptr() for x in
                     (tab.w_a, tab.w_b, tab.scale_a, tab.zp_a, tab.scale_b, tab.zp_b, proj)]
            ints += [tab.m, tab.w_a.shape[1], _TYPES[tab.w_a.dtype], int(tab.op == "mult"),
                     _vec_bytes(tab.w_a, tab.w_b, tpb)]
        _require(smem <= _SMEM_MAX, name, lambda: f"projections need {smem} B of shared memory "
                                                  f"per block, over {_SMEM_MAX}")
        out = torch.empty((b, n_tables, d_out), dtype=out_dtype, device=idx.device)
        if idx.device.type == "meta":
            return _build.meta_call(name, _bound_bytes(idx, idx_b, mask, tables, out), out)
        if b == 0:
            return out
        _call(counter, name, ptrs, ints, n_tables, idx, idx_b, idx.stride(), mask,
              (0, 0, 0) if mask is None else mask.stride(), out, length, bag, False, tpb, smem)
        return out


def launch_bag_pair(counter, name, idx, mask, w_a, w_b, *, m: int, op: str, idx_b=None):
    """K3's launch on one dense QR pair, counted on ``counter.launches``:
    ``launch(counter, name, idx[:, None], mask[:, None],
    [GroupTable(w_a, w_b, m=m, op=op)], bag=True, idx_b=idx_b[:, None])``
    with each weight rounded to a bf16 table's dtype before it multiplies,
    only the checks a dense pair needs, and no views (the host time of
    ``ops.qr_bag_lookup`` is mostly this function's).  ``(B, L)`` ids (raw,
    split by ``m > 0``, or pre-split with ``idx_b`` and ``m = 0``) and mask
    are read in place through their strides.  Returns ``(B, d)`` in the
    table dtype."""
    _build.refuse_grad(name, (mask, w_a, w_b))
    _require(idx.dim() == 2 and mask.shape == idx.shape, name,
             lambda: f"ids {tuple(idx.shape)} and mask {tuple(mask.shape)} are not one (B, L)")
    if idx.dtype not in _IDS:
        idx = idx.to(torch.int32)
    if idx_b is not None:
        _require(idx_b.shape == idx.shape, name, "pre-split ids differ in shape")
        idx_b = idx_b.to(idx.dtype)
        if idx_b.stride() != idx.stride():   # both are read through one set of strides
            idx, idx_b = idx.contiguous(), idx_b.contiguous()
    if mask.dtype not in _MASKS:
        mask = mask.to(torch.float32)
    _require(w_a.dtype in (torch.float32, torch.bfloat16) and w_b is not None
             and w_b.dtype == w_a.dtype and w_a.dim() == w_b.dim() == 2
             and w_b.shape[1] == w_a.shape[1] and w_a.is_contiguous() and w_b.is_contiguous(),
             name, "K3 takes dense f32 / bf16 QR pairs: contiguous (rows, d) of one dtype "
                   "and width")
    dtype, d = w_a.dtype, w_a.shape[1]
    _require(op in ("mult", "add"), name, lambda: f"op={op!r}: the kernel combines with mult "
                                                  "or add")
    _require(m >= 0 and (m > 0) == (idx_b is None), name,
             lambda: f"m={m}: raw ids split by m > 0, pre-split ids take m = 0")
    b, length = idx.shape
    tpb = _threads_per_bag(d * w_a.element_size())
    ptrs = (w_a.data_ptr(), w_b.data_ptr(), 0, 0, 0, 0, 0)
    ints = (m, d, _TYPES[dtype], int(op == "mult"), _vec_bytes(w_a, w_b, tpb))
    out = torch.empty((b, d), dtype=dtype, device=idx.device)   # (B, T=1, d) contiguous
    if idx.device.type == "meta":
        return _build.meta_call(name, _bound_bytes(idx[:, None], None if idx_b is None
                                                   else idx_b[:, None], mask[:, None],
                                                   [GroupTable(w_a, w_b, m=m, op=op)], out),
                                out)
    if b == 0:
        return out
    sb, sl = idx.stride()
    mb, ml = mask.stride()
    _call(counter, name, ptrs, ints, 1, idx, idx_b, (sb, 0, sl), mask, (mb, 0, ml), out,
          length, True, True, tpb, 0)
    return out


def _bound_bytes(idx, idx_b, mask, tables, out) -> int:
    """The bytes a call's bound counts (``PERF.md``'s kernel table): ids
    and mask once, each gathered row once, each projection once, the
    output once.  Without the ids' values (``meta``), a table's distinct
    rows are taken as many as its slots, at most its rows."""
    nbytes = sum(t.numel() * t.element_size() for t in (idx, idx_b, mask, out)
                 if t is not None)
    slots = idx.shape[0] * (idx.shape[2] if idx.dim() == 3 else 1)
    for tab in tables:
        for w, scale, zp in ((tab.w_a, tab.scale_a, tab.zp_a), (tab.w_b, tab.scale_b, tab.zp_b)):
            if w is None:
                continue
            row = w.shape[1] * w.element_size() + sum(
                x.element_size() for x in (scale, zp) if x is not None)
            nbytes += min(slots, w.shape[0]) * row
        if tab.proj is not None:
            nbytes += tab.proj.numel() * 4
    return nbytes


def _call(counter, name, ptrs, ints, n_tables, idx, idx_b, idx_strides, mask, mask_strides,
          out, length, bag, round_weight, tpb, smem):
    """The C entry on the current stream, counted on ``counter.launches``:
    the descriptors cross as flat host arrays (7 pointers, 5 ints per
    table), which it copies into the kernel's parameter."""
    ptrs, ints = array.array("Q", ptrs), array.array("i", ints)
    code = _build.library("grouped_lookup").grouped_lookup(
        ptrs.buffer_info()[0], ints.buffer_info()[0], n_tables,
        idx.data_ptr(), None if idx_b is None else idx_b.data_ptr(),
        int(idx.dtype == torch.int64), *idx_strides,
        None if mask is None else mask.data_ptr(),
        int(mask is not None and mask.dtype == torch.bfloat16), *mask_strides, out.data_ptr(),
        out.shape[0], length, out.shape[-1], int(out.dtype == torch.bfloat16), int(bag),
        int(round_weight), tpb, smem, torch.cuda.current_stream(idx.device).cuda_stream)
    _build.check("grouped_lookup", code, f"{name} launch")
    counter.launches += 1

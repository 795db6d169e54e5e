"""Training's one-hot QR pairs: ``QRPairs``, the autograd Function of the
embed stage's dense mult/add QR pairs, and K6 ``qr_pairs_backward``, its
backward: both tables' gradients of every pair in one grouped pass.

Kernel: ``csrc/qr_pairs_backward.cu`` (CUDA C++ for sm_90a).  It replaces
no Pallas kernel: the TPU kernel K1
(``repro/kernels/qr_gather.py::qr_gather``) has no backward, and the
reference trains through XLA's scatter-add of its plain gathers.  K6 is the
backward of K1's function, added because PyTorch's backward of the plain
gathers (``index_put_`` with accumulate) sums every duplicate of a row in
one thread per lane, one dependent add after another, and a QR table's
rows are nearly all duplicates (a quotient table of c = 4 rows takes a
quarter of the batch on each row).

Bound on the card: memory.  Each (pair, side, sample) entry reads its key
and position, the other table's row id and row, and its row of the output
gradient; each table gradient is zeroed and written once.  The wrapper
zeroes one flat buffer for every table's gradient, has the kernel write each
entry's key (its row of that buffer), sorts the keys stably
(``torch.sort``), and launches the kernel on the sorted entries: fixed
chunks of them are summed in parallel, in sorted order, and a run of equal
keys that crosses chunks is finished by one warp over the chunks' partial
sums in a fixed order.  No float atomics: the same inputs give the same
bits on every call.

For CPU tensors the wrapper returns the plain version
(``ref.qr_pairs_backward``); for CUDA tensors it launches the kernel or
raises.  ``qr_pairs_backward.launches`` counts its calls that launch (one a
call: the keys, then the two passes over the sorted entries).
"""

from __future__ import annotations

import array

import torch
from torch.autograd.function import once_differentiable

from ..obs.trace import span
from . import _build, ref

__all__ = ["MAX_PAIRS", "CHUNK", "QRPairs", "qr_pairs", "qr_pairs_backward"]

MAX_PAIRS = 40           # kMaxPairs of csrc/qr_pairs_backward.cu
CHUNK = 64               # sorted entries a group of lanes sums in order
_TYPES = (torch.float32, torch.bfloat16)
_IDS = (torch.int32, torch.int64)
_MAX_VEC = {torch.float32: 16, torch.bfloat16: 8}


class QRPairs(torch.autograd.Function):
    """``outs[p] = tables[2p][rem[p]] op_p tables[2p + 1][quo[p]]`` for P
    QR pairs: the forward runs the plain gathers and combine the per-table
    route runs (``CompositionalEmbedding.apply``), and keeps the tables and
    the row ids, not the gathered rows; the backward is one
    ``qr_pairs_backward`` call for every pair.  ``ops``: P of ``"mult"`` /
    ``"add"``; ``rem`` / ``quo``: P ``(B,)`` row ids.  Once differentiable:
    a double backward raises."""

    @staticmethod
    def forward(ctx, ops, rem, quo, *tables):
        outs = []
        for p, op in enumerate(ops):
            a, b = tables[2 * p][rem[p].long()], tables[2 * p + 1][quo[p].long()]
            outs.append(a * b if op == "mult" else a + b)
        ctx.ops, ctx.rem, ctx.quo = ops, rem, quo
        ctx.save_for_backward(*tables)
        return tuple(outs)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        grads_w = qr_pairs_backward(grads, ctx.rem, ctx.quo, ctx.saved_tensors, ctx.ops)
        return (None, None, None, *grads_w)


def qr_pairs(rem, quo, tables, ops):
    """``QRPairs`` over P pairs: ``rem`` / ``quo`` P ``(B,)`` row ids,
    ``tables`` the 2P tables (remainder, quotient, pair by pair), ``ops`` P
    of ``"mult"`` / ``"add"`` → P ``(B, D)`` outputs."""
    return QRPairs.apply(tuple(ops), tuple(rem), tuple(quo), *tables)


def _require(cond: bool, what) -> None:
    if not cond:
        raise ValueError(f"qr_pairs_backward: {what() if callable(what) else what}")


def _vec_bytes(dtype, d, tables, grads) -> int:
    """The widest load (16 bytes for f32, 8 for bf16, down to one element)
    that divides a row and is aligned on every table and gradient row."""
    elem = 4 if dtype == torch.float32 else 2
    vb = _MAX_VEC[dtype]
    ptrs = [t.data_ptr() for t in tables] + [g.data_ptr() for g in grads] \
        + [g.stride(0) * elem for g in grads]
    while vb > elem and ((d * elem) % vb or any(p % vb for p in ptrs)):
        vb //= 2
    return vb


def _bound_bytes(grads, rem, quo, tables, ops) -> int:
    """The bytes a call's bound counts (``PERF.md``'s kernel table): each
    gradient row and both ids of each sample read once per side, the other
    table's row read once per entry of a ``mult`` pair, and every table's
    gradient written once."""
    nbytes = 2 * sum(g.numel() * g.element_size() for g in grads)
    nbytes += 2 * sum(r.numel() * r.element_size() for r in (*rem, *quo))
    nbytes += sum(t.numel() * t.element_size() for t in tables)
    d, elem = tables[0].shape[1], tables[0].element_size()
    return nbytes + sum(2 * r.numel() * d * elem for r, op in zip(rem, ops) if op == "mult")


def qr_pairs_backward(grads, rem, quo, tables, ops):
    """K6: the gradients of P QR pairs' tables from the gradients ``grads``
    (P ``(B, D)``) of their outputs: for pair p,

        grad tables[2p][r]     = sum over samples n with rem[p][n] = r of
                                 grads[p][n] * tables[2p + 1][quo[p][n]]
        grad tables[2p + 1][q] = sum over samples n with quo[p][n] = q of
                                 grads[p][n] * tables[2p][rem[p][n]]

    (``add``: ``grads[p][n]`` alone), summed in f32 and rounded once to the
    tables' dtype.  ``tables``: 2P contiguous ``(rows, D)`` f32 or bf16
    tables of one dtype and width; ``rem`` / ``quo``: P ``(B,)`` int32 or
    int64 row ids, in ``[-rows, rows)``; ``ops``: P of ``"mult"`` / ``"add"``.
    Returns the 2P gradients in the tables' order, views of one flat buffer,
    zeroed once.  The host side of the call is one ``repro.launch`` span."""
    _require(all(op in ("mult", "add") for op in ops),
             lambda: f"ops {ops}: the kernel combines with mult or add")
    n_pairs = len(ops)
    _require(n_pairs >= 1 and len(grads) == len(rem) == len(quo) == n_pairs
             and len(tables) == 2 * n_pairs,
             lambda: f"{len(grads)} gradients, {len(rem)} / {len(quo)} id vectors and "
                     f"{len(tables)} tables for {n_pairs} pairs")
    device = _build.launch_device(*grads, *rem, *quo, *tables)
    if device is None:
        return ref.qr_pairs_backward(grads, rem, quo, tables, ops)
    with span("repro.launch", kernel="qr_pairs_backward", pairs=n_pairs):
        _require(1 <= n_pairs <= MAX_PAIRS,
                 lambda: f"{n_pairs} pairs; one call takes 1..{MAX_PAIRS}")
        dtype, d = tables[0].dtype, tables[0].shape[-1]
        _require(dtype in _TYPES, lambda: f"dtype {dtype} not f32 or bf16")
        _require(all(t.dim() == 2 and t.dtype == dtype and t.shape[1] == d and t.shape[0] >= 1
                     and t.is_contiguous() for t in tables),
                 "tables are contiguous (rows, d) of one dtype and width, with a row or more")
        b = rem[0].shape[0] if rem[0].dim() == 1 else -1
        _require(all(r.dim() == 1 and r.shape[0] == b and r.dtype in _IDS for r in (*rem, *quo)),
                 "row ids are int32 or int64 (B,), alike for every pair")
        _require(all(g.shape == (b, d) and g.dtype == dtype for g in grads),
                 lambda: f"gradients are ({b}, {d}) in {dtype}")
        if len({r.dtype for r in (*rem, *quo)}) > 1:
            rem, quo = [r.long() for r in rem], [q.long() for q in quo]
        rem, quo = [r.contiguous() for r in rem], [q.contiguous() for q in quo]
        grads = [g if g.stride(1) == 1 else g.contiguous() for g in grads]
        rows = [t.shape[0] for t in tables]
        _require(sum(rows) < 2 ** 31, lambda: f"{sum(rows)} table rows; the keys are int32")
        flat = torch.zeros((sum(rows), d), dtype=dtype, device=device)
        views = list(torch.split(flat, rows))
        if device.type == "meta":
            return _build.meta_call("qr_pairs_backward", _bound_bytes(grads, rem, quo, tables, ops),
                                    views)
        if b == 0:
            return views
        _launch(grads, rem, quo, tables, ops, rows, flat, device)
        return views


def _launch(grads, rem, quo, tables, ops, rows, flat, device):
    """Keys, the stable sort, then the kernel's passes on the current
    stream, counted on ``qr_pairs_backward.launches``: the descriptors
    cross as flat host arrays (5 pointers, 6 ints per pair)."""
    n_pairs, b = len(ops), rem[0].shape[0]
    dtype, d = flat.dtype, flat.shape[1]
    offsets = [sum(rows[:k]) for k in range(len(rows))]
    ptrs = array.array("Q", [x for p in range(n_pairs) for x in (
        rem[p].data_ptr(), quo[p].data_ptr(), tables[2 * p].data_ptr(),
        tables[2 * p + 1].data_ptr(), grads[p].data_ptr())])
    ints = array.array("q", [x for p in range(n_pairs) for x in (
        grads[p].stride(0), rows[2 * p], rows[2 * p + 1], offsets[2 * p], offsets[2 * p + 1],
        int(ops[p] == "mult"))])
    ids64 = int(rem[0].dtype == torch.int64)
    stream = torch.cuda.current_stream(device).cuda_stream
    lib = _build.library("qr_pairs_backward")
    keys = torch.empty((2 * n_pairs * b,), dtype=torch.int32, device=device)
    code = lib.qr_pairs_keys(ptrs.buffer_info()[0], ints.buffer_info()[0], n_pairs, b, ids64,
                             keys.data_ptr(), stream)
    _build.check("qr_pairs_backward", code, "qr_pairs_backward keys launch")
    keys, perm = torch.sort(keys, stable=True)
    chunks = -(-keys.numel() // CHUNK)
    piece = torch.empty((chunks, d), dtype=torch.float32, device=device)
    owned = torch.empty((chunks, d), dtype=torch.float32, device=device)
    vb = _vec_bytes(dtype, d, tables, grads)
    lanes = min(32, 1 << max(0, (d * flat.element_size() // vb - 1).bit_length()))
    code = lib.qr_pairs_backward(
        ptrs.buffer_info()[0], ints.buffer_info()[0], n_pairs, b, d, ids64,
        int(dtype == torch.bfloat16), vb, lanes, CHUNK, keys.data_ptr(), perm.data_ptr(),
        flat.data_ptr(), piece.data_ptr(), owned.data_ptr(), stream)
    _build.check("qr_pairs_backward", code, "qr_pairs_backward launch")
    qr_pairs_backward.launches += 1


qr_pairs_backward.launches = 0

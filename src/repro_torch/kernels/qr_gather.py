"""One-hot quotient-remainder lookup: ``w_rem[rem] op w_quo[quo]`` per id.

Kernels: ``csrc/qr_gather.cu`` (CUDA C++ for sm_90a) for K1 ``qr_gather``
on dense tables, replacing the Pallas TPU kernel
``repro/kernels/qr_gather.py::qr_gather``; ``csrc/grouped_lookup.cu`` for
K5 ``qr_gather_quant`` on int8 pairs, replacing
``repro/kernels/qr_gather.py::qr_gather_quant``.  K5 has a per-table entry
(pre-split ids, one table) and ``qr_gather_quant_grouped``, which looks up
every table of a batch in one launch from the raw ids and splits them in
the kernel.

Bound on the card: memory.  A call gathers two short scattered rows per id
(64 bytes each for f32 at D=16, 19 for an int8 row with its scale and
zero point) and writes one row, with 1 (K1) or 5 (K5) f32 operations per
element.  K1 has a group of threads own one output row, load its two ids
itself and read each gathered row once as a contiguous run.  K5 reads the
stored bf16 scale and int8 zero point of each gathered row; where the TPU
wrapper built a ``(rows, 2)`` f32 metadata table from the whole quantized
table on every call, a call here does nothing table-wide.

For CPU tensors the wrappers return the plain versions
(``kernels/ref.py``); for CUDA tensors they launch the kernel or raise.
``qr_gather.launches`` and ``qr_gather_quant.launches`` count launches
(the latter of both K5 entries).
"""

from __future__ import annotations

import torch

from . import _build, grouped_lookup, ref

__all__ = ["qr_gather", "qr_gather_quant", "qr_gather_quant_grouped"]

_TABLE_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def _require(cond: bool, name: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {what}")


def _check_op(name, op):
    _require(op in ("mult", "add"), name, f"op={op!r}: the kernel combines with mult or add")


def _check_ids(name, rem, quo):
    _require(rem.dim() == 1 and rem.shape == quo.shape, name,
             f"ids are (N,) and alike, got {tuple(rem.shape)} and {tuple(quo.shape)}")
    return rem.to(torch.int32).contiguous(), quo.to(torch.int32).contiguous()


def _check_tables(name, w_rem, w_quo):
    _require(w_rem.dim() == 2 and w_quo.dim() == 2 and w_rem.is_contiguous()
             and w_quo.is_contiguous(), name, "tables are contiguous (rows, d)")
    _require(w_rem.dtype == w_quo.dtype and w_rem.shape[1] == w_quo.shape[1], name,
             "both tables of a pair share dtype and width")


def qr_gather(rem, quo, w_rem, w_quo, *, op: str = "mult"):
    """K1: ``(N,)`` remainder / quotient ids into dense f32 or bf16
    ``(m, d)`` / ``(q, d)`` tables → ``(N, d)`` in the table dtype."""
    _check_op("qr_gather", op)
    device = _build.launch_device(rem, quo, w_rem, w_quo)
    if device is None:
        return ref.qr_gather(rem, quo, w_rem, w_quo, op=op)
    rem, quo = _check_ids("qr_gather", rem, quo)
    _check_tables("qr_gather", w_rem, w_quo)
    _require(w_rem.dtype in _TABLE_TYPES, "qr_gather", f"table dtype {w_rem.dtype} not f32/bf16")
    n, d = rem.shape[0], w_rem.shape[1]
    out = torch.empty((n, d), dtype=w_rem.dtype, device=device)
    if n == 0 or d == 0:
        return out
    code = _build.library("qr_gather").qr_gather(
        rem.data_ptr(), quo.data_ptr(), w_rem.data_ptr(), w_quo.data_ptr(), out.data_ptr(),
        n, d, _TABLE_TYPES[w_rem.dtype], int(op == "mult"),
        torch.cuda.current_stream(device).cuda_stream)
    _build.check("qr_gather", code, "qr_gather launch")
    qr_gather.launches += 1
    return out


def qr_gather_quant(rem, quo, q_rem, q_quo, scale_rem, zp_rem, scale_quo, zp_quo, *,
                    op: str = "mult"):
    """K5: ``(N,)`` ids into an int8 QR pair (``q`` int8 ``(rows, d)``,
    ``scale`` bf16 and ``zp`` int8 ``(rows, 1)`` per table) → f32
    ``(N, d)`` of dequantized, combined rows."""
    _check_op("qr_gather_quant", op)
    operands = (rem, quo, q_rem, q_quo, scale_rem, zp_rem, scale_quo, zp_quo)
    if _build.launch_device(*operands) is None:
        return ref.qr_gather_quant(*operands, op=op)
    _require(rem.dim() == 1, "qr_gather_quant", f"ids are (N,), got {tuple(rem.shape)}")
    table = ref.GroupTable(q_rem, q_quo, scale_rem, zp_rem, scale_quo, zp_quo, 0, op)
    out = grouped_lookup.launch(qr_gather_quant, "qr_gather_quant", rem[:, None], None,
                                [table], bag=False, idx_b=quo[:, None])
    return out[:, 0]


def qr_gather_quant_grouped(idx, tables):
    """K5 over every table of a batch in one launch: ``idx`` int ``(B, T)``
    raw ids, non-negative and below each table's size; ``tables``: T int8
    QR-pair ``ref.GroupTable``s, split by their ``m`` inside the kernel.
    Returns f32 ``(B, T, d)``."""
    if _build.launch_device(idx, *(x for t in tables for x in t.tensors())) is None:
        return ref.qr_gather_quant_grouped(idx, tables)
    return grouped_lookup.launch(qr_gather_quant, "qr_gather_quant_grouped", idx, None,
                                 tables, bag=False)


qr_gather.launches = 0
qr_gather_quant.launches = 0

"""One-hot quotient-remainder lookup: ``w_rem[rem] op w_quo[quo]`` per id.

Kernel: ``csrc/grouped_lookup.cu`` (CUDA C++ for sm_90a), for K1
``qr_gather`` on dense f32 / bf16 pairs, replacing the Pallas TPU kernel
``repro/kernels/qr_gather.py::qr_gather``, and for K5 ``qr_gather_quant``
on int8 pairs, replacing ``repro/kernels/qr_gather.py::qr_gather_quant``.
Each has a per-table entry (pre-split ids, one table) and a grouped one
(``qr_gather_grouped``, ``qr_gather_quant_grouped``), which looks up every
table of a batch in one launch from the raw ids and splits them in the
kernel.

Bound on the card: memory.  A call gathers two short scattered rows per id
(64 bytes each for f32 at D=16, 19 for an int8 row with its scale and
zero point) and writes one row, with 1 (K1) or 5 (K5) f32 operations per
element.  A group of threads owns one output row, loads its id itself and
reads each gathered row in loads of up to 16 bytes.  K5 reads the stored
bf16 scale and int8 zero point of each gathered row; where the TPU wrapper
built a ``(rows, 2)`` f32 metadata table from the whole quantized table on
every call, a call here does nothing table-wide.

For CPU tensors the wrappers return the plain versions
(``kernels/ref.py``); for CUDA tensors they launch the kernel or raise.
``qr_gather.launches`` and ``qr_gather_quant.launches`` count launches
(each of both its entries).
"""

from __future__ import annotations

from . import _build, grouped_lookup, ref

__all__ = ["qr_gather", "qr_gather_quant", "qr_gather_grouped", "qr_gather_quant_grouped"]


def _check_op(name, op):
    if op not in ("mult", "add"):
        raise ValueError(f"{name}: op={op!r}: the kernel combines with mult or add")


def _check_ids(name, rem):
    if rem.dim() != 1:
        raise ValueError(f"{name}: ids are (N,), got {tuple(rem.shape)}")


def qr_gather(rem, quo, w_rem, w_quo, *, op: str = "mult"):
    """K1: ``(N,)`` remainder / quotient ids into dense f32 or bf16
    ``(m, d)`` / ``(q, d)`` tables → ``(N, d)`` in the table dtype."""
    _check_op("qr_gather", op)
    if _build.launch_device(rem, quo, w_rem, w_quo) is None:
        return ref.qr_gather(rem, quo, w_rem, w_quo, op=op)
    _check_ids("qr_gather", rem)
    table = ref.GroupTable(w_rem, w_quo, m=0, op=op)
    out = grouped_lookup.launch(qr_gather, "qr_gather", rem[:, None], None, [table],
                                bag=False, idx_b=quo[:, None])
    return out[:, 0]


def qr_gather_quant(rem, quo, q_rem, q_quo, scale_rem, zp_rem, scale_quo, zp_quo, *,
                    op: str = "mult"):
    """K5: ``(N,)`` ids into an int8 QR pair (``q`` int8 ``(rows, d)``,
    ``scale`` bf16 and ``zp`` int8 ``(rows, 1)`` per table) → f32
    ``(N, d)`` of dequantized, combined rows."""
    _check_op("qr_gather_quant", op)
    operands = (rem, quo, q_rem, q_quo, scale_rem, zp_rem, scale_quo, zp_quo)
    if _build.launch_device(*operands) is None:
        return ref.qr_gather_quant(*operands, op=op)
    _check_ids("qr_gather_quant", rem)
    table = ref.GroupTable(q_rem, q_quo, scale_rem, zp_rem, scale_quo, zp_quo, 0, op)
    out = grouped_lookup.launch(qr_gather_quant, "qr_gather_quant", rem[:, None], None,
                                [table], bag=False, idx_b=quo[:, None])
    return out[:, 0]


def qr_gather_grouped(idx, tables):
    """K1 over every table of a batch in one launch: ``idx`` int ``(B, T)``
    raw ids, non-negative and below each table's size; ``tables``: T dense
    QR-pair ``ref.GroupTable``s of one dtype (f32 or bf16), split by their
    ``m`` inside the kernel.  Returns ``(B, T, d)`` in the table dtype."""
    if _build.launch_device(idx, *(x for t in tables for x in t.tensors())) is None:
        return ref.qr_gather_grouped(idx, tables)
    return grouped_lookup.launch(qr_gather, "qr_gather_grouped", idx, None, tables, bag=False)


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

"""One-hot quotient-remainder lookup: ``w_rem[rem] op w_quo[quo]`` per id.

Kernels: ``csrc/qr_gather.cu`` (CUDA C++ for sm_90a), one source with two
entry points, replacing the Pallas TPU kernels
``repro/kernels/qr_gather.py::qr_gather`` (K1, dense tables) and
``::qr_gather_quant`` (K5, an int8 pair).

Bound on the card: memory.  A call gathers two short scattered rows per id
(64 bytes each for f32 at D=16, 19 for an int8 row with its scale and
zero point) and writes one row, with 1 (K1) or 5 (K5) f32 operations per
element.  The design has a group of threads own one output row, load its
two ids itself and read each gathered row once as a contiguous run.  K5
reads the stored bf16 scale and int8 zero point of each gathered row;
where the TPU wrapper built a ``(rows, 2)`` f32 metadata table from the
whole quantized table on every call, a call here does nothing table-wide.

For CPU tensors the wrappers return the plain versions
(``kernels/ref.py``); for CUDA tensors they launch the kernel or raise.
``qr_gather.launches`` and ``qr_gather_quant.launches`` count launches.
"""

from __future__ import annotations

import torch

from . import _build, ref

__all__ = ["qr_gather", "qr_gather_quant"]

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
    device = _build.launch_device(*operands)
    if device is None:
        return ref.qr_gather_quant(*operands, op=op)
    rem, quo = _check_ids("qr_gather_quant", rem, quo)
    _check_tables("qr_gather_quant", q_rem, q_quo)
    _require(q_rem.dtype == torch.int8, "qr_gather_quant", f"table dtype {q_rem.dtype} not int8")
    for q, scale, zp in ((q_rem, scale_rem, zp_rem), (q_quo, scale_quo, zp_quo)):
        _require(scale.dtype == torch.bfloat16 and zp.dtype == torch.int8, "qr_gather_quant",
                 "scale is bf16 and zp int8")
        _require(scale.shape == (q.shape[0], 1) and zp.shape == (q.shape[0], 1)
                 and scale.is_contiguous() and zp.is_contiguous(), "qr_gather_quant",
                 "scale and zp are contiguous (rows, 1)")
    n, d = rem.shape[0], q_rem.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=device)
    if n == 0 or d == 0:
        return out
    code = _build.library("qr_gather").qr_gather_quant(
        rem.data_ptr(), quo.data_ptr(), q_rem.data_ptr(), q_quo.data_ptr(),
        scale_rem.data_ptr(), zp_rem.data_ptr(), scale_quo.data_ptr(), zp_quo.data_ptr(),
        out.data_ptr(), n, d, int(op == "mult"), torch.cuda.current_stream(device).cuda_stream)
    _build.check("qr_gather", code, "qr_gather_quant launch")
    qr_gather_quant.launches += 1
    return out


qr_gather.launches = 0
qr_gather_quant.launches = 0

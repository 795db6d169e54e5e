"""Multi-hot quotient-remainder embedding bag: ``out[b] = sum_l mask[b, l] *
(w_rem[rem[b, l]] op w_quo[quo[b, l]])``, summed in f32, one rounding to
the table dtype.

Kernel: ``csrc/embedding_bag.cu`` (CUDA C++ for sm_90a), replacing the
Pallas TPU kernel ``repro/kernels/embedding_bag.py::qr_embedding_bag``.

Bound on the card: memory.  A bag gathers 2L short scattered rows and
writes one, with 3 f32 operations per element of a slot.  The design has
a group of threads own one bag and loop over its slots in order with an
f32 register accumulator, so each gathered row is read once and the bag
rounds once.  As in the reference, the mask is cast to the table dtype
before it weighs a row, so a fractional weight on a bf16 table multiplies
as its bf16 rounding; the wrapper does that cast and the kernel reads the
mask in the table dtype.

For CPU tensors the wrapper returns the plain version
(``kernels/ref.py``); for CUDA tensors it launches the kernel or raises.
``qr_embedding_bag.launches`` counts launches.
"""

from __future__ import annotations

import torch

from . import _build, ref

__all__ = ["qr_embedding_bag"]

_TABLE_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"qr_embedding_bag: {what}")


def qr_embedding_bag(rem, quo, mask, w_rem, w_quo, *, op: str = "mult"):
    """``(B, L)`` remainder / quotient ids and mask into dense f32 or bf16
    ``(m, d)`` / ``(q, d)`` tables → ``(B, d)`` pooled bags in the table
    dtype.  ``L = 0`` pools to zeros."""
    _require(op in ("mult", "add"), f"op={op!r}: the kernel combines with mult or add")
    device = _build.launch_device(rem, quo, mask, w_rem, w_quo)
    if device is None:
        return ref.qr_embedding_bag(rem, quo, mask, w_rem, w_quo, op=op)
    _require(rem.dim() == 2 and rem.shape == quo.shape == mask.shape,
             f"ids and mask are (B, L) and alike, got {tuple(rem.shape)}, "
             f"{tuple(quo.shape)} and {tuple(mask.shape)}")
    _require(w_rem.dim() == 2 and w_quo.dim() == 2 and w_rem.is_contiguous()
             and w_quo.is_contiguous(), "tables are contiguous (rows, d)")
    _require(w_rem.dtype == w_quo.dtype and w_rem.shape[1] == w_quo.shape[1],
             "both tables of a pair share dtype and width")
    _require(w_rem.dtype in _TABLE_TYPES, f"table dtype {w_rem.dtype} not f32/bf16")
    rem = rem.to(torch.int32).contiguous()
    quo = quo.to(torch.int32).contiguous()
    mask = mask.to(w_rem.dtype).contiguous()      # the reference's rounding of the weights
    (b, length), d = rem.shape, w_rem.shape[1]
    out = torch.empty((b, d), dtype=w_rem.dtype, device=device)
    if b == 0 or d == 0:
        return out
    code = _build.library("embedding_bag").qr_embedding_bag(
        rem.data_ptr(), quo.data_ptr(), mask.data_ptr(), w_rem.data_ptr(), w_quo.data_ptr(),
        out.data_ptr(), b, length, d, _TABLE_TYPES[w_rem.dtype], int(op == "mult"),
        torch.cuda.current_stream(device).cuda_stream)
    _build.check("embedding_bag", code, "qr_embedding_bag launch")
    qr_embedding_bag.launches += 1
    return out


qr_embedding_bag.launches = 0

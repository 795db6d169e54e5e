"""Multi-hot quotient-remainder embedding bag: ``out[b] = sum_l mask[b, l] *
(w_rem[rem[b, l]] op w_quo[quo[b, l]])``, summed in f32, one rounding to
the table dtype.

Kernel: ``csrc/grouped_lookup.cu`` (CUDA C++ for sm_90a), its dense pooled
case, replacing the Pallas TPU kernel
``repro/kernels/embedding_bag.py::qr_embedding_bag``.  The per-table entry
``qr_embedding_bag`` takes pre-split ids, and ``qr_embedding_bag_raw``
(``ops.qr_bag_lookup``'s route) raw ids, which the kernel splits; both
launch the kernel with one table.

Bound on the card: memory.  A bag gathers 2L scattered rows and writes
one, with 3 f32 operations per element of a slot.  At D=128 f32 a row is
512 bytes, and a bag of L=32 over a table far above L2 reads its rows
cold: there the time is bandwidth, and the launcher keeps several rows of
each bag in flight per thread in 16-byte loads.  As in the reference, the
mask is rounded to the table dtype before it weighs a row, so a fractional
weight on a bf16 table multiplies as its bf16 rounding; the kernel rounds
it, reading an f32 or bf16 mask in place.  A mask of any other dtype is
converted once to the table dtype here.

For CPU tensors the wrappers return the plain versions
(``kernels/ref.py``); for CUDA tensors they launch the kernel or raise.
``qr_embedding_bag.launches`` counts the launches of both entries.
"""

from __future__ import annotations

import torch

from . import _build, grouped_lookup, ref

__all__ = ["qr_embedding_bag", "qr_embedding_bag_raw"]


def _check_op(name, op):
    if op not in ("mult", "add"):
        raise ValueError(f"{name}: op={op!r}: the kernel combines with mult or add")


def _weights(mask, table):
    """The mask as the kernel reads it: f32 or bf16 in place, any other
    dtype rounded once to the table dtype (the reference's rounding)."""
    return mask if mask.dtype in (torch.float32, torch.bfloat16) else mask.to(table.dtype)


def qr_embedding_bag(rem, quo, mask, w_rem, w_quo, *, op: str = "mult"):
    """``(B, L)`` remainder / quotient ids and mask into dense f32 or bf16
    ``(m, d)`` / ``(q, d)`` tables → ``(B, d)`` pooled bags in the table
    dtype.  ``L = 0`` pools to zeros."""
    _check_op("qr_embedding_bag", op)
    if _build.launch_device(rem, quo, mask, w_rem, w_quo) is None:
        return ref.qr_embedding_bag(rem, quo, mask, w_rem, w_quo, op=op)
    return grouped_lookup.launch_bag_pair(qr_embedding_bag, "qr_embedding_bag", rem,
                                          _weights(mask, w_rem), w_rem, w_quo, m=0, op=op,
                                          idx_b=quo)


def qr_embedding_bag_raw(idx, mask, w_rem, w_quo, *, op: str = "mult"):
    """K3 on raw ids of one dense QR pair: ``(B, L)`` ids, non-negative and
    below ``m * q``, split ``(i % m, i // m)`` inside the kernel by the
    ``m`` rows of ``w_rem`` → ``(B, d)`` in the table dtype
    (``ops.qr_bag_lookup``'s route: one launch, no device operation
    before it)."""
    _check_op("qr_embedding_bag_raw", op)
    if _build.launch_device(idx, mask, w_rem, w_quo) is None:
        return ref.qr_embedding_bag_raw(idx, mask, w_rem, w_quo, op=op)
    return grouped_lookup.launch_bag_pair(qr_embedding_bag, "qr_embedding_bag_raw", idx,
                                          _weights(mask, w_rem), w_rem, w_quo,
                                          m=w_rem.shape[0], op=op)


qr_embedding_bag.launches = 0

"""The entry points models call around the kernels.

They split QR ids into (remainder, quotient) rows, pick the fused kernel
for what it covers and the plain tensor path for what it does not
(``op="concat"`` pairs and pairs that mix a dense and a quantized table,
on either device).  Whether a kernel launches is the kernel wrapper's
decision: a CPU tensor takes the plain version, a CUDA tensor the kernel.
"""

from __future__ import annotations

import torch

from ..core.compositional import is_quantized_table, table_rows
from . import ref
from .dot_interaction import dot_interaction
from .embedding_bag import qr_embedding_bag
from .qr_gather import qr_gather, qr_gather_quant
from .serve_path import fused_serve_pool

__all__ = ["qr_lookup", "qr_bag_lookup", "serve_bag_pool", "dlrm_interact"]


def _rows(table) -> int:
    return (table["q"] if is_quantized_table(table) else table).shape[0]


def _operands(table):
    """(stored table, scale, zp) — scale and zp are None for dense tables."""
    if is_quantized_table(table):
        return table["q"], table["scale"], table["zp"]
    return table, None, None


def _split(idx, w_rem):
    m = _rows(w_rem)
    return idx % m, idx // m


def _plain_pair(w_rem, w_quo, rem, quo, op):
    """Gather per table (dequantizing int8 rows) and combine, as plain
    tensor operations: ``concat`` and a mixed dense+int8 pair."""
    a, b = table_rows(w_rem, rem), table_rows(w_quo, quo)
    if op == "concat":
        return torch.cat([a, b], dim=-1)
    return a * b if op == "mult" else a + b


def _plain_bag(w_rem, w_quo, rem, quo, mask, op):
    """``_plain_pair``'s rows, masked and summed in f32 over the bag, one
    rounding: f32 when either table is quantized, else the table dtype."""
    rows = _plain_pair(w_rem, w_quo, rem, quo, op).to(torch.float32)
    pooled = torch.sum(rows * mask[..., None].to(torch.float32), dim=1, dtype=torch.float32)
    quant = is_quantized_table(w_rem) or is_quantized_table(w_quo)
    return pooled if quant else pooled.to(w_rem.dtype)


def qr_lookup(idx, w_rem, w_quo, *, op: str = "mult", use_kernel: bool = True):
    """QR-trick embedding lookup for ``idx`` of any rank → ``idx.shape + (d,)``.

    Tables may be dense tensors or row-quantized dicts (``serve.quantize``).
    An int8 pair with ``mult``/``add`` goes through K5 (f32 out), a dense
    pair through K1 (table dtype out); ``concat`` and a mixed dense+int8
    pair take plain tensor code on either device.  ``use_kernel=False``
    computes the same function with the plain versions.
    """
    rem, quo = _split(idx, w_rem)
    shape = rem.shape
    rem, quo = rem.reshape(-1), quo.reshape(-1)
    quant_rem, quant_quo = is_quantized_table(w_rem), is_quantized_table(w_quo)
    if op == "concat" or quant_rem != quant_quo:
        out = _plain_pair(w_rem, w_quo, rem, quo, op)
    elif quant_rem:
        gather = qr_gather_quant if use_kernel else ref.qr_gather_quant
        out = gather(rem, quo, w_rem["q"], w_quo["q"], w_rem["scale"], w_rem["zp"],
                     w_quo["scale"], w_quo["zp"], op=op)
    else:
        gather = qr_gather if use_kernel else ref.qr_gather
        out = gather(rem, quo, w_rem, w_quo, op=op)
    return out.reshape(*shape, out.shape[-1])


def qr_bag_lookup(idx, mask, w_rem, w_quo, *, op: str = "mult", use_kernel: bool = True):
    """Sum-pooled multi-hot QR lookup: ``idx``/``mask`` ``(B, L)`` → ``(B, d)``.

    A dense pair with ``mult``/``add`` goes through K3 (pooled in f32, one
    rounding to the table dtype).  A quantized pair, on either side, pools
    its dequantized rows in f32 and returns f32; ``concat`` pools in f32
    and rounds once to the table dtype — plain tensor code on either
    device, as the reference does.  ``use_kernel=False`` computes the same
    function with the plain version.
    """
    rem, quo = _split(idx, w_rem)
    if op == "concat" or is_quantized_table(w_rem) or is_quantized_table(w_quo):
        return _plain_bag(w_rem, w_quo, rem, quo, mask, op)
    bag = qr_embedding_bag if use_kernel else ref.qr_embedding_bag
    return bag(rem, quo, mask, w_rem, w_quo, op=op)


def serve_bag_pool(idx, mask, w_a, w_b=None, *, op: str = "mult", proj=None,
                   use_kernel: bool = True):
    """Serving pooled lookup: gather (+dequant) → pool → project.

    ``w_a`` (and the optional quotient table ``w_b``) may be dense tensors
    or row-quantized dicts (``serve.quantize``).  With ``w_b`` given,
    ``idx`` is raw and split ``(i % m, i // m)`` here; single-table callers
    (full / hash) pass pre-folded ids.  ``proj`` is the mixed-width
    ``(d, D)`` projection.  ``use_kernel=False`` computes the same function
    with the plain version, on any device.
    """
    quant_a = is_quantized_table(w_a)
    quant_b = is_quantized_table(w_b) if w_b is not None else quant_a
    idx_a, idx_b = _split(idx, w_a) if w_b is not None else (idx, None)
    fusable = (w_b is None or op in ("mult", "add")) and quant_a == quant_b
    if not fusable:
        # concat / mixed dense+quant pair: gather per table, combine, pool
        # in f32, project — the same contract with plain tensor operations
        pooled = _plain_bag(w_a, w_b, idx_a, idx_b, mask, op)
        return pooled if proj is None else pooled.to(torch.float32) @ proj.to(torch.float32)
    qa, sa, za = _operands(w_a)
    qb, sb, zb = _operands(w_b) if w_b is not None else (None, None, None)
    pool = fused_serve_pool if use_kernel else ref.fused_serve_pool
    return pool(idx_a, mask, qa, idx_b, qb, sa, za, sb, zb, proj, op=op)


def dlrm_interact(x, *, use_kernel: bool = True):
    """DLRM pairwise-dot interaction ``(B, F, D) → (B, F(F-1)/2)``."""
    return dot_interaction(x) if use_kernel else ref.dot_interaction(x)

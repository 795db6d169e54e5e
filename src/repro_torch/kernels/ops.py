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
from .serve_path import fused_serve_pool

__all__ = ["serve_bag_pool", "dlrm_interact"]


def _rows(table) -> int:
    return (table["q"] if is_quantized_table(table) else table).shape[0]


def _operands(table):
    """(stored table, scale, zp) — scale and zp are None for dense tables."""
    if is_quantized_table(table):
        return table["q"], table["scale"], table["zp"]
    return table, None, None


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
    if w_b is not None:
        m = _rows(w_a)
        idx_a, idx_b = idx % m, idx // m
    else:
        idx_a, idx_b = idx, None
    fusable = (w_b is None or op in ("mult", "add")) and quant_a == quant_b
    if not fusable:
        # concat / mixed dense+quant pair: gather per table, combine, pool
        # in f32, project — the same contract with plain tensor operations
        a, b = table_rows(w_a, idx_a), table_rows(w_b, idx_b)
        rows = (torch.cat([a, b], dim=-1) if op == "concat"
                else (a * b if op == "mult" else a + b))
        pooled = torch.sum(rows.to(torch.float32) * mask[..., None].to(torch.float32),
                           dim=1, dtype=torch.float32)
        pooled = pooled.to(torch.float32 if (quant_a or quant_b) else a.dtype)
        return pooled if proj is None else pooled.to(torch.float32) @ proj.to(torch.float32)
    qa, sa, za = _operands(w_a)
    qb, sb, zb = _operands(w_b) if w_b is not None else (None, None, None)
    pool = fused_serve_pool if use_kernel else ref.fused_serve_pool
    return pool(idx_a, mask, qa, idx_b, qb, sa, za, sb, zb, proj, op=op)


def dlrm_interact(x, *, use_kernel: bool = True):
    """DLRM pairwise-dot interaction ``(B, F, D) → (B, F(F-1)/2)``."""
    return dot_interaction(x) if use_kernel else ref.dot_interaction(x)

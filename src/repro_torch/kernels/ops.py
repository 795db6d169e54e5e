"""The entry points models call around the kernels.

They split QR ids into (remainder, quotient) rows, pick the fused kernel
for what it covers and the plain tensor path for what it does not
(``op="concat"`` pairs and pairs that mix a dense and a quantized table,
on either device).  The grouped entries look up every feature of a wave
or batch in one launch, with the id split inside the kernel.  ``qr_pairs``
takes training's dense QR pairs through an autograd Function whose
backward is K6.  Whether a kernel launches is the kernel wrapper's
decision: a CPU tensor takes the plain version, a CUDA tensor the kernel.
"""

from __future__ import annotations

import torch

from ..core.compositional import is_quantized_table, table_rows
from . import ref
from .grouped_lookup import MAX_TABLES
from .dot_interaction import dot_interaction, dot_interaction_concat
from .embedding_bag import qr_embedding_bag_raw
from .qr_gather import qr_gather, qr_gather_grouped, qr_gather_quant, qr_gather_quant_grouped
from .qr_pairs_backward import MAX_PAIRS, qr_pairs
from .serve_path import fused_serve_pool, fused_serve_pool_grouped

__all__ = ["qr_lookup", "qr_bag_lookup", "serve_bag_pool", "dlrm_interact",
           "dlrm_interact_concat", "serve_bag_pool_grouped", "qr_lookup_grouped", "qr_pairs",
           "MAX_PAIRS"]


def _rows(table) -> int:
    return (table["q"] if is_quantized_table(table) else table).shape[0]


def _operands(table):
    """(stored table, scale, zp) — scale and zp are None for dense tables."""
    if is_quantized_table(table):
        return table["q"], table["scale"], table["zp"]
    return table, None, None


def _fusable(w_a, w_b, op) -> bool:
    """Whether the fused serving kernel takes the table (pair): a single
    table, or a mult/add pair whose two tables are both dense or both
    quantized."""
    if w_b is None:
        return True
    return op in ("mult", "add") and is_quantized_table(w_a) == is_quantized_table(w_b)


def _group_table(w_a, w_b, m, op, proj):
    qa, sa, za = _operands(w_a)
    qb, sb, zb = _operands(w_b) if w_b is not None else (None, None, None)
    return ref.GroupTable(qa, qb, sa, za, sb, zb, _rows(w_a) if w_b is not None else m,
                          op, proj)


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
    rounding to the table dtype) in one launch: the raw ids and the mask
    are read in place and the kernel splits the ids.  A quantized
    pair, on either side, pools its dequantized rows in f32 and returns
    f32; ``concat`` pools in f32 and rounds once to the table dtype — plain
    tensor code on either device, as the reference does.
    ``use_kernel=False`` computes the same function with the plain version.
    """
    if op == "concat" or is_quantized_table(w_rem) or is_quantized_table(w_quo):
        return _plain_bag(w_rem, w_quo, *_split(idx, w_rem), mask, op)
    bag = qr_embedding_bag_raw if use_kernel else ref.qr_embedding_bag_raw
    return bag(idx, mask, w_rem, w_quo, op=op)


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
    idx_a, idx_b = _split(idx, w_a) if w_b is not None else (idx, None)
    if not _fusable(w_a, w_b, op):
        # concat / mixed dense+quant pair: gather per table, combine, pool
        # in f32, project — the same contract with plain tensor operations
        pooled = _plain_bag(w_a, w_b, idx_a, idx_b, mask, op)
        return pooled if proj is None else pooled.to(torch.float32) @ proj.to(torch.float32)
    qa, sa, za = _operands(w_a)
    qb, sb, zb = _operands(w_b) if w_b is not None else (None, None, None)
    pool = fused_serve_pool if use_kernel else ref.fused_serve_pool
    return pool(idx_a, mask, qa, idx_b, qb, sa, za, sb, zb, proj, op=op)


def _chunked(lookup, idx, mask, group):
    """``lookup`` over ``group`` in launches of at most ``MAX_TABLES``
    tables (the kernel's cap), each on its slice of the table axis; the
    slices' ``(B, t, D)`` results join on that axis.  Split the same way on
    every device, so the plain versions run the same slices."""
    if len(group) <= MAX_TABLES:
        return lookup(idx, mask, group)
    return torch.cat([lookup(idx[:, s:s + MAX_TABLES],
                             None if mask is None else mask[:, s:s + MAX_TABLES],
                             group[s:s + MAX_TABLES])
                      for s in range(0, len(group), MAX_TABLES)], dim=1)


def serve_bag_pool_grouped(idx, mask, tables):
    """Serving pooled lookup of every feature in one kernel launch:
    ``idx``/``mask`` ``(B, T, L)`` raw ids and weights (``mask=None``:
    weight 1) → ``(B, T, D)``.

    ``tables`` holds one ``(w_a, w_b, m, op, proj)`` per feature, each
    table dense or row-quantized: a QR pair (``w_b`` given) splits the ids
    by ``w_a``'s rows; a single table folds them ``i % m`` (a hash table)
    or, with ``m = 0``, takes them as given (a full table).  Returns None,
    launching nothing, unless the fused kernel takes every table
    (``serve_bag_pool``'s rule) and they all pool to one dtype: the caller
    then keeps its per-table route.  More tables than one launch takes
    (``MAX_TABLES``) go in several launches.
    """
    if not all(_fusable(w_a, w_b, op) for w_a, w_b, _, op, _ in tables):
        return None
    group = [_group_table(*spec) for spec in tables]
    if len({ref.pool_out_dtype(t) for t in group}) != 1:
        return None
    return _chunked(fused_serve_pool_grouped, idx, mask, group)


def qr_lookup_grouped(idx, tables):
    """One-hot QR lookup of every feature in one launch: ``idx`` ``(B, T)``
    raw ids → ``(B, T, D)``; ``tables`` as for ``serve_bag_pool_grouped``.
    Every table an int8 mult/add QR pair: K5, f32 out.  Every table a dense
    mult/add QR pair of one dtype (f32 or bf16): K1, out in that dtype.
    Any other set (a full or hash table, a projection, a mixed pair, or a
    mix of kinds or dtypes) returns None, launching nothing: the caller
    keeps its per-table route.  More tables than one launch takes
    (``MAX_TABLES``) go in several launches."""
    kinds = set()
    for w_a, w_b, _, op, proj in tables:
        if w_b is None or op not in ("mult", "add") or proj is not None:
            return None
        kinds |= {"int8" if is_quantized_table(w) else w.dtype for w in (w_a, w_b)}
    if kinds == {"int8"}:
        lookup = qr_gather_quant_grouped
    elif kinds in ({torch.float32}, {torch.bfloat16}):
        lookup = qr_gather_grouped
    else:
        return None
    return _chunked(lambda ids, _, group: lookup(ids, group), idx, None,
                    [_group_table(*spec) for spec in tables])


def dlrm_interact(x, *, use_kernel: bool = True):
    """DLRM pairwise-dot interaction ``(B, F, D) → (B, F(F-1)/2)``."""
    return dot_interaction(x) if use_kernel else ref.dot_interaction(x)


def dlrm_interact_concat(z, feats, *, use_kernel: bool = True):
    """The top MLP's input ``[z, tril(X·Xᵀ)]`` for ``X = [z; feats]``,
    ``z (B, D)``, ``feats (B, T, D)`` → ``(B, D + F(F-1)/2)``: K2 reads
    both in place and writes it whole."""
    return (dot_interaction_concat(z, feats) if use_kernel
            else ref.dot_interaction_concat(z, feats))

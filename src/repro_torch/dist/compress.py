"""Error-feedback compressed gradient reduction (bf16 / int8), as the JAX
package's ``dist/compress.py``.

Data-parallel training all-reduces one full gradient copy per step.
Compressing the reduction to bf16 (2 B/elem) or int8 (1 B/elem + one f32
scale per leaf) cuts that 2–4×, and **error feedback** (Karimireddy et
al., 2019) keeps the *time-averaged* update unbiased: the residual each
compression step throws away is carried forward and added to the next
gradient, so the sum of emitted gradients telescopes to the sum of true
gradients.

``mode`` may be a single string, a per-leaf tree or flat list of strings,
or a ``policy.CompressionPolicy``; ``init_error_state`` allocates
residual state only for leaves that compress (a 0-d placeholder
otherwise).

The reference reduces over a ``shard_map`` axis name; here ``group`` is a
``torch.distributed`` process group, and ``group=None`` keeps the
reference's ``axis_name=None``: local compression only, no collective.
Every collective goes through ``dist.wire``, which counts its bytes.

Wire formats.  Both compressed modes use a **two-phase exchange** instead
of an all-reduce of the narrow dtype (an int8 sum must widen to int32,
and backends without narrow arithmetic widen bf16):

* Phase 1: compress locally (bf16 cast, or int8 with a max-shared scale)
  and all-to-all the payload so each rank owns one shard of every peer's
  compressed gradient; sum it **in f32** (int32 for int8 — exact:
  ≤ 127·n) in rank order, so the reduction is deterministic.
* Phase 2: re-compress the shard mean and all-gather it.

All inputs to phase 2 are bitwise identical across ranks, so every rank
emits the same reduced gradient and the per-rank optimizer updates stay
in lock-step without a re-broadcast.  For int8, **two-level error
feedback** charges each rank ``n×`` its own shard's phase-2
requantization residual, so the emitted-gradient sum telescopes over
both compression levels (``two_level=True``, the default).

The FSDP path's building block is ``_reduce_scatter_leaf`` (used by
``train.loop.make_fsdp_train_step``): the same compression, but the
reduction lands as this rank's shard along one dim, so phase 2 is
skipped.  Its ``none`` mode is an all-to-all plus a rank-order f32 sum
rather than the backend's reduce-scatter, whose summation order is the
backend's: the card and the CPU then sum alike, and the ring bytes are a
reduce-scatter's.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import tree
from ..optim.optimizers import leaf_paths
from . import wire

__all__ = ["quantize_int8", "init_error_state", "ef_psum_grads", "MODES", "resolve_modes"]

MODES = ("none", "bf16", "int8")
_TINY = torch.finfo(torch.float32).tiny


def _f32(value, like):
    """A 0-d f32 tensor on ``like``'s device.  Dividing by it is a true
    division on every device: CUDA computes ``x / python_scalar`` as a
    multiply by the reciprocal, the CPU divides."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def quantize_int8(x):
    """Symmetric per-tensor int8 quantisation.

    Returns ``(q, scale)`` with ``q`` int8 in [-127, 127] and
    ``x ≈ q * scale``; round-half-to-even bounds the error by ``scale / 2``.
    """
    x32 = x.to(torch.float32)
    amax = torch.max(torch.abs(x32))
    scale = torch.clamp(amax / _f32(127.0, amax), min=_TINY)
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale


def resolve_modes(tree_like, mode) -> list[str]:
    """Per-leaf mode list for ``tree_like``: accepts a single mode string, a
    flat list, a tree of strings, or a policy object with ``.modes()``."""
    n_leaves = len(tree.leaves(tree_like))
    if hasattr(mode, "modes"):  # CompressionPolicy (duck-typed: no import cycle)
        flat = mode.modes(tree_like)
    elif isinstance(mode, str):
        flat = [mode] * n_leaves
    else:
        flat = tree.leaves(mode)
    if len(flat) != n_leaves:
        raise ValueError("mode tree does not match gradient tree "
                         f"({len(flat)} vs {n_leaves} leaves)")
    for m in flat:
        if m not in MODES:
            raise ValueError(f"unknown compression mode {m!r}; expected one of {MODES}")
    return flat


def init_error_state(grads_like, mode=None):
    """Zero residual per gradient leaf (f32 whatever the gradient's dtype),
    on each leaf's device.  With ``mode``, residual state is allocated only
    for compressed leaves; ``"none"`` leaves get a 0-d placeholder."""
    leaves = tree.leaves(grads_like)
    modes = ["__full__"] * len(leaves) if mode is None else resolve_modes(grads_like, mode)
    out = [torch.zeros(() if m == "none" else tuple(g.shape), dtype=torch.float32,
                       device=g.device)
           for g, m in zip(leaves, modes)]
    return tree.unflatten(grads_like, out)


def _shared_scale(v, group, leaf="_unnamed"):
    """Quantisation scale agreed across the group (max) so integer partial
    sums are exact and bitwise identical on every rank.

    The reference writes ``amax / 127.0``; XLA compiles a division by a
    constant into a multiply by the f32 reciprocal, and the reference's
    step only runs compiled.  The collective path multiplies by that
    reciprocal (as it does for its ``/ n``), so the reduced gradients
    equal the compiled reference's bit for bit, on the CPU and on the
    card alike (the product and the quotient differ by at most one ulp).
    ``quantize_int8``, the local path, divides, as the reference's
    uncompiled call does."""
    amax = torch.max(torch.abs(v))
    if group is not None:
        amax = wire.all_reduce(amax, group, op="max", leaf=leaf)
    return torch.clamp(amax * _f32(1.0 / 127.0, amax), min=_TINY)


def _quant(v, scale):
    return torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)


def _rank_order_sum(rows):
    """The f32 sum of ``rows`` (n, k) over dim 0, in rank order."""
    acc = rows[0].to(torch.float32)
    for r in range(1, rows.shape[0]):
        acc = acc + rows[r].to(torch.float32)
    return acc


def _compressed_allreduce_mean(v, group, mode, two_level=True, leaf="_unnamed"):
    """Two-phase compressed-on-the-wire mean-all-reduce (module docstring).

    Returns ``(mean, charged)``: the replicated mean estimate and what
    error feedback charges this rank for — its decompressed phase-1
    contribution, minus (with ``two_level``, int8 only) the phase-2
    requantization residual of its own shard scaled by ``n``.
    """
    n = dist.get_world_size(group)
    if mode == "bf16":
        payload = v.to(torch.bfloat16)          # bf16 on the wire
        deq = payload.to(torch.float32)
    else:  # int8
        scale = _shared_scale(v, group, leaf)
        payload = _quant(v, scale)
        deq = payload.to(torch.float32) * scale
    if n == 1:
        return deq, deq
    flat = payload.reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, torch.zeros((pad,), dtype=flat.dtype, device=flat.device)])
    # phase 1: each rank ends up holding every peer's copy of its shard
    mine = wire.all_to_all(flat.reshape(n, -1), group, leaf=leaf)
    corr = None
    if mode == "bf16":
        y = _rank_order_sum(mine) * _f32(1.0 / n, mine)
        out = wire.all_gather(y.to(torch.bfloat16), group, leaf=leaf).to(torch.float32)
    else:
        shard_sum = torch.sum(mine.to(torch.int32), dim=0)   # exact: ≤ 127·n
        y = shard_sum.to(torch.float32) * (scale * _f32(1.0 / n, scale))
        scale2 = _shared_scale(y, group, leaf)
        q2 = _quant(y, scale2)
        out = wire.all_gather(q2, group, leaf=leaf).to(torch.float32) * scale2
        if two_level:
            r2 = y - q2.to(torch.float32) * scale2      # this shard's phase-2 loss
            corr = torch.zeros(flat.shape, dtype=torch.float32, device=flat.device)
            start = dist.get_rank(group) * y.shape[0]
            corr[start:start + y.shape[0]] = n * r2
    if pad:
        out = out[:-pad]
        corr = corr[:-pad] if corr is not None else None
    charged = deq if corr is None else deq - corr.reshape(v.shape)
    return out.reshape(v.shape), charged


def _reduce_leaf(g, e, group, mode, two_level=True, leaf="_unnamed"):
    """Compressed mean-all-reduce of one leaf → (reduced_full, new_err)."""
    v = g.to(torch.float32) + e
    if mode == "none":
        if group is not None:
            out = wire.all_reduce(v, group, leaf=leaf) * _f32(
                1.0 / dist.get_world_size(group), v)
        else:
            out = v
        return out.to(g.dtype), torch.zeros_like(e)
    if mode == "bf16":
        if group is not None:
            out, deq = _compressed_allreduce_mean(v, group, mode, leaf=leaf)
        else:
            out = deq = v.to(torch.bfloat16).to(torch.float32)
        return out.to(g.dtype), v - deq
    if mode == "int8":
        if group is not None:
            out, deq = _compressed_allreduce_mean(v, group, mode, two_level=two_level,
                                                  leaf=leaf)
        else:
            q, scale = quantize_int8(v)
            deq = q.to(torch.float32) * scale
            out = deq
        return out.to(g.dtype), v - deq
    raise ValueError(f"unknown compression mode {mode!r}; expected one of {MODES}")


def _fused_residual(v, q, scale):
    """``v - q·scale`` rounded once, as the compiled reference computes it
    (XLA fuses it into a multiply-add): in f64 the product of an int8 and
    an f32 is exact, and so is the difference (``|v - q·scale| ≤ scale/2``
    and ``|v| ≤ 127.5·scale`` span few binades), so one cast to f32 is the
    one rounding of the fused form."""
    return (v.to(torch.float64) - q.to(torch.float64) * scale.to(torch.float64)).to(torch.float32)


def _exchange_blocks(x, group, dim, leaf):
    """Split ``x`` into ``n`` blocks along ``dim``, send block ``r`` to rank
    ``r``, and return what came back as ``(n, *block_shape)``: row ``r`` is
    rank ``r``'s block of this rank's position (``lax.all_to_all(split_axis=
    dim, concat_axis=dim, tiled=True)``, with the peers stacked in front)."""
    n = dist.get_world_size(group)
    moved = x.movedim(dim, 0)
    block = (moved.shape[0] // n,) + tuple(moved.shape[1:])
    mine = wire.all_to_all(moved.reshape(n, -1), group, leaf=leaf)
    return mine.reshape((n,) + block).movedim(1, dim + 1)


def _reduce_scatter_leaf(g, e, group, mode, dim, leaf="_unnamed"):
    """Compressed mean-reduce-scatter of one leaf along ``dim``.

    Returns ``(shard, new_err)``: this rank's shard of the mean gradient
    (``shape[dim] / n`` along ``dim``, f32) and the full-shape residual.
    The compressed modes stop after phase 1 of the two-phase exchange — the
    shard sum *is* the reduce-scatter, so only (n−1)/n · {2, 1} B/elem
    cross the wire.  ``none`` sums the peers' f32 blocks in rank order.
    """
    n = dist.get_world_size(group)
    v = g.to(torch.float32) + e
    if n == 1:
        red, new_e = _reduce_leaf(g, e, None, mode)
        return red.to(torch.float32), new_e
    if mode == "none":
        mine = _exchange_blocks(v, group, dim, leaf)
        return _rank_order_sum(mine) * _f32(1.0 / n, v), torch.zeros_like(e)
    if mode == "bf16":
        c = v.to(torch.bfloat16)                # bf16 on the wire
        mine = _exchange_blocks(c, group, dim, leaf)
        return _rank_order_sum(mine) * _f32(1.0 / n, v), v - c.to(torch.float32)
    if mode == "int8":
        scale = _shared_scale(v, group, leaf)
        q = _quant(v, scale)
        mine = _exchange_blocks(q, group, dim, leaf)
        shard_sum = torch.sum(mine.to(torch.int32), dim=0)      # exact: ≤ 127·n
        return (shard_sum.to(torch.float32) * (scale * _f32(1.0 / n, scale)),
                _fused_residual(v, q, scale))
    raise ValueError(f"unknown compression mode {mode!r}; expected one of {MODES}")


@torch.no_grad()
def ef_psum_grads(grads, err, *, group=None, mode="bf16", two_level=True):
    """Compressed (mean-)reduction of a gradient tree with error feedback.

    Args:
      grads: gradient tree.
      err: residual tree from the previous step (``init_error_state`` to
        start); the same leaves as ``grads``.
      group: the ``torch.distributed`` process group to reduce over, or
        ``None`` for local compression only.
      mode: ``"none" | "bf16" | "int8"``, a per-leaf tree / flat list of
        those, or a ``policy.CompressionPolicy``.
      two_level: carry the int8 phase-2 requantization residual into the
        error state as well; off reproduces the single-level behaviour.

    Returns ``(reduced_grads, new_err)``.  The reduction is a *mean* over
    the group, matching a per-shard-mean loss.  Leaves are reduced in
    leaf order, so every rank issues the same collectives in the same
    order; each is logged under its leaf's path.
    """
    flat_g = tree.leaves(grads)
    flat_e = tree.leaves(err)
    if len(flat_e) != len(flat_g):
        raise ValueError("error state does not match gradient tree "
                         f"({len(flat_e)} vs {len(flat_g)} leaves)")
    modes = resolve_modes(grads, mode)
    out = [_reduce_leaf(g, e, group, m, two_level=two_level, leaf=p)
           for g, e, m, p in zip(flat_g, flat_e, modes, leaf_paths(grads))]
    return (tree.unflatten(grads, [o[0] for o in out]),
            tree.unflatten(grads, [o[1] for o in out]))

"""Per-step collective wire-byte accounting from a gradient tree and a
policy, as the JAX package's ``dist/accounting.py``.

Computes how many bytes each device puts on the wire per training step
under a compression policy, with the ring formulas per device:

    all-reduce       2·(n−1)/n · bytes
    all-gather       (n−1)/n · gathered bytes
    reduce-scatter   (n−1) · shard bytes  =  (n−1)/n · full bytes
    all-to-all       (n−1)/n · bytes

Per-mode wire cost of reducing one leaf of E elements on the DP path:

==========  =============================
mode        DP all-reduce path
==========  =============================
``none``    2(n−1)/n · 4E
``bf16``    2(n−1)/n · 2E′
``int8``    2(n−1)/n · 1E′ + scales
==========  =============================

(E′ = E padded to a multiple of n — the compressed all-reduce is the
two-phase all_to_all + all_gather exchange over the flattened leaf;
"scales" are the two max-shared f32 scalar all-reduces, int8 only.)  The
formulas are pure arithmetic and give the reference's floats exactly.
``dist.wire`` applies the same formulas to the tensors each collective
really hands over, so ``benchmarks/dist_bench.py`` cross-checks the two.

``fsdp_step_wire_bytes`` prices the FSDP step (reduce-scatter of the
scattered leaves, all-reduce of the rest, the parameter all-gather) and
``serve_wave_wire_bytes`` the sharded serving wave's row exchange.
"""

from __future__ import annotations

import math

from .. import tree
from ..optim.optimizers import leaf_paths
from .compress import resolve_modes

__all__ = ["leaf_reduce_bytes", "grad_wire_bytes", "dp_step_wire_bytes",
           "fsdp_step_wire_bytes", "ring_all_reduce_bytes",
           "ring_all_gather_bytes", "ring_reduce_scatter_bytes",
           "ring_all_to_all_bytes", "serve_exchange_wire_bytes",
           "serve_wave_wire_bytes"]

_SCALE_BYTES = 4  # one f32 scalar per max-shared quantisation scale


def ring_all_reduce_bytes(nbytes: float, n: int) -> float:
    return 2.0 * (n - 1) / n * nbytes


def ring_all_gather_bytes(gathered_nbytes: float, n: int) -> float:
    return (n - 1) / n * gathered_nbytes


def ring_reduce_scatter_bytes(full_nbytes: float, n: int) -> float:
    return (n - 1) / n * full_nbytes


def ring_all_to_all_bytes(nbytes: float, n: int) -> float:
    return (n - 1) / n * nbytes


def leaf_reduce_bytes(mode: str, nelems: int, n: int, *,
                      pattern: str = "all_reduce") -> float:
    """Wire bytes per device to reduce one gradient leaf.

    ``pattern``: ``"all_reduce"`` (DP step — every device ends with the
    full reduced leaf) or ``"reduce_scatter"`` (FSDP step — each device
    ends with its shard; no phase-2 gather for int8).
    """
    if n <= 1 or nelems == 0:
        return 0.0
    if mode == "none":
        full = 4.0 * nelems
        return (ring_all_reduce_bytes(full, n) if pattern == "all_reduce"
                else ring_reduce_scatter_bytes(full, n))
    if mode == "bf16":
        if pattern == "all_reduce":
            padded = 2.0 * math.ceil(nelems / n) * n
            return ring_all_to_all_bytes(padded, n) + ring_all_gather_bytes(padded, n)
        return ring_reduce_scatter_bytes(2.0 * nelems, n)
    if mode == "int8":
        scale = ring_all_reduce_bytes(_SCALE_BYTES, n)
        if pattern == "all_reduce":
            padded = float(math.ceil(nelems / n) * n)
            return (ring_all_to_all_bytes(padded, n)
                    + ring_all_gather_bytes(padded, n) + 2 * scale)
        return ring_all_to_all_bytes(float(nelems), n) + scale
    raise ValueError(f"unknown compression mode {mode!r}")


def grad_wire_bytes(grads_like, policy, n: int, *, pattern: str = "all_reduce",
                    scattered=None) -> dict:
    """Per-leaf + aggregate reduction wire bytes for a gradient tree.

    ``policy`` is anything ``compress.resolve_modes`` accepts (mode string,
    per-leaf tree or list, ``CompressionPolicy``).  ``scattered``
    (optional, per leaf, flat) marks which leaves reduce-scatter;
    unscattered leaves take the all-reduce pattern.
    """
    leaves = tree.leaves(grads_like)
    paths = leaf_paths(grads_like)
    modes = resolve_modes(grads_like, policy)
    if scattered is None:
        scattered = [pattern == "reduce_scatter"] * len(leaves)
    per_leaf = []
    per_mode: dict[str, float] = {}
    total = 0.0
    for path, leaf, mode, scat in zip(paths, leaves, modes, scattered):
        nelems = int(math.prod(leaf.shape)) if tuple(leaf.shape) else 1
        b = leaf_reduce_bytes(mode, nelems, n,
                              pattern="reduce_scatter" if scat else "all_reduce")
        per_leaf.append({"path": path, "mode": mode, "nelems": nelems, "wire_bytes": b})
        per_mode[mode] = per_mode.get(mode, 0.0) + b
        total += b
    return {"total_bytes": total, "per_mode": per_mode, "per_leaf": per_leaf,
            "n_devices": n, "pattern": pattern}


def serve_exchange_wire_bytes(lookups: int, width: int, n: int, *,
                              quantized: bool = True,
                              row_dtype_bytes: int = 4) -> dict:
    """Per-device wire bytes of one row-sharded serve exchange for one
    sub-table and wave: two all-to-all phases over ``(n, C)``-shaped
    buffers (C = ``lookups``) — int32 ids out, rows back (int8 ``q`` +
    bf16 ``scale`` + int8 ``zp`` per row when quantized, else
    ``row_dtype_bytes`` per element)."""
    ids = ring_all_to_all_bytes(4.0 * n * lookups, n)
    if quantized:
        rows = (ring_all_to_all_bytes(1.0 * n * lookups * width, n)
                + ring_all_to_all_bytes(2.0 * n * lookups, n)
                + ring_all_to_all_bytes(1.0 * n * lookups, n))
    else:
        rows = ring_all_to_all_bytes(float(row_dtype_bytes) * n * lookups * width, n)
    return {"ids_bytes": ids, "rows_bytes": rows, "total_bytes": ids + rows}


def serve_wave_wire_bytes(placement, batch_per_device: int, bag_len: int) -> dict:
    """Per-device wire bytes of one sharded serve wave: the sum of
    ``serve_exchange_wire_bytes`` over the placement's row-sharded
    sub-tables, each fetching ``batch_per_device · bag_len`` rows.
    Replicated sub-tables cost nothing."""
    n = placement.n_devices
    lookups = batch_per_device * bag_len
    per_entry = []
    total = 0.0
    for e in placement.sharded:
        # stored element width of a dense sub-table (4 f32, 2 bf16), from
        # the placement's byte accounting
        dtype_bytes = (e.bytes_total // max(e.rows * e.width, 1) if not e.quantized else 4)
        b = serve_exchange_wire_bytes(lookups, e.width, n, quantized=e.quantized,
                                      row_dtype_bytes=dtype_bytes)
        per_entry.append({"path": e.path, "width": e.width, "quantized": e.quantized, **b})
        total += b["total_bytes"]
    return {"total_bytes": total, "lookups_per_device": lookups, "n_devices": n,
            "per_entry": per_entry}


def _scalar_overhead(n: int, n_scalars: int) -> float:
    """f32 scalar all-reduces outside the gradient reduction (loss and
    metric means)."""
    return n_scalars * ring_all_reduce_bytes(4.0, n)


def dp_step_wire_bytes(params_like, policy, n: int, *, scalar_allreduces: int = 0) -> dict:
    """Accounted wire bytes for one ``make_dp_train_step`` step."""
    grads = grad_wire_bytes(params_like, policy, n, pattern="all_reduce")
    overhead = _scalar_overhead(n, scalar_allreduces)
    return {"grad_bytes": grads["total_bytes"], "param_gather_bytes": 0.0,
            "overhead_bytes": overhead,
            "total_bytes": grads["total_bytes"] + overhead,
            "per_mode": grads["per_mode"], "n_devices": n}


def fsdp_step_wire_bytes(params_like, optimizer, mesh, policy, *, axis: str = "data",
                         scalar_allreduces: int = 0, param_gather_dtype="float32") -> dict:
    """Accounted wire bytes for one ``make_fsdp_train_step`` step:
    compressed gradient reduce-scatter + all-gather of every scattered
    parameter shard (f32, or 2 B/elem with ``param_gather_dtype=
    "bfloat16"``).  ``mesh`` is the axis sizes (``dist.sharding.
    axis_sizes``)."""
    from ..train.loop import _gather_dtype, fsdp_plan
    from .sharding import axis_sizes
    n = axis_sizes(mesh, axis).get(axis, 1)
    plan = fsdp_plan(params_like, optimizer, mesh, policy=policy, axis=axis)
    scattered = [dim is not None for (_, _, _, dim) in plan]
    grads = grad_wire_bytes(params_like, policy, n, pattern="reduce_scatter",
                            scattered=scattered)
    gbytes = float(_gather_dtype(param_gather_dtype).itemsize)
    gather = sum(ring_all_gather_bytes(gbytes * math.prod(shape), n)
                 for (_, shape, _, dim) in plan if dim is not None)
    overhead = _scalar_overhead(n, scalar_allreduces)
    return {"grad_bytes": grads["total_bytes"], "param_gather_bytes": gather,
            "overhead_bytes": overhead,
            "total_bytes": grads["total_bytes"] + gather + overhead,
            "per_mode": grads["per_mode"], "n_devices": n,
            "n_scattered": sum(scattered), "n_leaves": len(plan)}

"""Live table migration between memory plans — warm-start, never retrain.

When the online controller re-solves the plan for drifted traffic, the new
table structures (full / hash / QR / mixed-radix, possibly new widths)
start life as random inits.  Serving them cold would throw away everything
the old tables learned.  This module folds the *old* structure's learned
state into the new one using the partitions' own index maps, as the JAX
package's ``online.migrate`` does:

* every new sub-table row has a **representative raw id** — the smallest
  category id landing in that bucket (closed form for the remainder /
  quotient / mixed-radix families, a scan for explicit partitions);
* the old model's *combined* embedding at those representatives (via
  ``module.apply``, so quantized tables dequantize exactly as serving
  does) becomes the new row, carried across width changes through the
  per-feature projections (project old→interaction width, then
  least-squares back through the pseudo-inverse of the new projection);
* for compositional targets one **carrier** partition receives the folded
  rows and the others start neutral (ones for ``mult``, zeros for
  ``add``), so the combined embedding of every id whose representative is
  itself — the Zipf-hot head ids ``0..m-1`` of a head-injective carrier —
  is *exactly* the old model's row.  ``concat`` targets fold
  per-partition slices instead;
* **same-spec tables are copied bitwise** (modulo dequantization), and
  full→full is an identity copy;
* optimizer moments migrate per-leaf by path+shape match (carried) or
  reset to the optimizer's init, with every choice recorded.

The rows stay tensors on the params' device: old rows are gathered in
chunks of ``_CHUNK`` representatives on the old params' device, and the
migrated leaves land on the new params' device.  Only the representative
ids (numpy, as the reference computes them) and each ``(d, D)``
projection's pseudo-inverse (numpy's, at the reference's f32 precision)
are made on the host.

The migrated tree has *exactly* the new init's structure and shapes, so
it can never exceed the new plan's byte budget.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tree

__all__ = ["representative_ids", "migrate_feature", "migrate_params",
           "migrate_opt_state"]

_CHUNK = 8192  # representatives per old-row gather


# ------------------------------------------------------------ index maps

def representative_ids(partition) -> np.ndarray:
    """Smallest raw id per bucket, ``(num_buckets,)`` int64 — the planner's
    index maps inverted.  Closed forms for the arithmetic families:

    * remainder ``x % m``          → ``b``  (ids 0..m-1 are their own reps)
    * quotient  ``x // m``         → ``b * m``
    * mixed-radix ``(x // M) % m`` → ``b * M``

    Buckets no id reaches (padding buckets of a clipped radix product)
    get rep ``size - 1`` — harmless, they receive no traffic.  Explicit
    partitions scan their table for first occurrences.
    """
    from ..core.partitions import (ExplicitPartition, GeneralizedQRPartition,
                                   QuotientPartition, RemainderPartition)
    n, size = partition.num_buckets, partition.size
    if isinstance(partition, RemainderPartition):
        reps = np.arange(n, dtype=np.int64)
    elif isinstance(partition, QuotientPartition):
        reps = np.arange(n, dtype=np.int64) * partition.m
    elif isinstance(partition, GeneralizedQRPartition):
        reps = np.arange(n, dtype=np.int64) * partition.divisor
    else:
        if isinstance(partition, ExplicitPartition):
            buckets = np.asarray(partition.table[:size], np.int64)
        else:  # generic: a brute-force bucket scan
            buckets = np.asarray(partition.bucket(np.arange(size)), np.int64)
        reps = np.full(n, size - 1, np.int64)
        uniq, first = np.unique(buckets, return_index=True)
        reps[uniq] = first
    return np.minimum(reps, size - 1)


def _head_injective(partition) -> bool:
    """True when ``bucket(x) == x`` for every ``x < num_buckets`` — such a
    partition's head rows fold exactly (the Zipf head lives there)."""
    from ..core.partitions import (GeneralizedQRPartition, QuotientPartition,
                                   RemainderPartition)
    if isinstance(partition, RemainderPartition):
        return True
    if isinstance(partition, GeneralizedQRPartition):
        return partition.divisor == 1
    if isinstance(partition, QuotientPartition):
        return partition.m == 1
    return False


def _carrier_index(partitions) -> int:
    """Which partition receives the folded rows: prefer head-injective
    (hot head ids are preserved exactly), then the most buckets (most of
    the old state survives)."""
    return min(range(len(partitions)),
               key=lambda j: (not _head_injective(partitions[j]),
                              -partitions[j].num_buckets))


# ------------------------------------------------------------ row folding

def _device_of(params) -> torch.device:
    return next(leaf.device for leaf in tree.leaves(params))


def _old_rows(old_mod, old_tp, ids: np.ndarray) -> torch.Tensor:
    """Combined (dequantized) f32 rows ``(len(ids), d_old)`` of the old
    model at raw ``ids``, on the old params' device — ``module.apply`` in
    chunks of ``_CHUNK`` ids, the same math serving's miss path runs."""
    device = _device_of(old_tp)
    ids_t = torch.as_tensor(ids, dtype=torch.int64).to(device)
    out = [old_mod.apply(old_tp, ids_t[lo:lo + _CHUNK]).to(torch.float32)
           for lo in range(0, len(ids), _CHUNK)]
    return torch.cat(out) if out else torch.empty((0, old_mod.out_dim), device=device)


def _pinv(proj) -> torch.Tensor:
    """The pseudo-inverse of a ``(d, D)`` projection, numpy's at f32 (the
    reference's expression), on the projection's device."""
    m = proj.detach().to("cpu", torch.float32).numpy()
    return torch.from_numpy(np.linalg.pinv(m)).to(proj.device)


def _to_width(rows, old_proj, new_proj, d_new: int):
    """Carry ``(n, d_old)`` rows to the new table width.  Equal widths pass
    through (the projection itself is carried separately); otherwise rows
    go old→interaction width through the old projection and back down
    through the pseudo-inverse of the new one, so
    ``migrated_row @ new_proj ≈ old_row @ old_proj``."""
    if rows.shape[1] == d_new:
        return rows
    e = rows if old_proj is None else rows @ old_proj.to(rows.device, torch.float32)
    if e.shape[1] == d_new:
        return e
    return e @ _pinv(new_proj).to(rows.device)


def _dequant_leaf(leaf):
    from ..core import is_quantized_table
    from ..serve.quantize import dequantize_table
    if is_quantized_table(leaf):
        return dequantize_table(leaf)
    return leaf


def _leaf_shape(leaf) -> tuple:
    return tuple((leaf["q"] if isinstance(leaf, dict) else leaf).shape)


def _same_module(a, b) -> bool:
    try:
        return bool(a == b)
    except (ValueError, TypeError):  # ExplicitPartition array equality is ambiguous
        return False


def _as_leaf(rows, like):
    """``rows`` as a leaf like ``like``: its dtype, on its device."""
    return rows.to(like.device, like.dtype)


def migrate_feature(old_mod, old_tp, new_mod, new_tp, *,
                    old_proj=None, new_proj=None):
    """Warm-start one feature's new table params from its old state.

    Returns ``(table_params, proj_entry, decision)`` where ``table_params``
    matches ``new_tp``'s structure/shapes/dtypes/device exactly,
    ``proj_entry`` is the per-feature projection to install (None when the
    new width is the interaction width), and ``decision`` is the JSON-safe
    audit record for the plan notes.
    """
    from ..core import CompositionalEmbedding
    from ..plan.quality import module_partitions
    d_new = new_mod.out_dim
    decision = {"from": type(old_mod).__name__, "to": type(new_mod).__name__,
                "from_dim": int(old_mod.out_dim), "to_dim": int(d_new)}

    same = _same_module(old_mod, new_mod) and all(
        _leaf_shape(old_tp[k]) == tuple(new_tp[k].shape) for k in new_tp if k in old_tp)
    if same and set(old_tp) == set(new_tp):
        out = {k: _as_leaf(_dequant_leaf(old_tp[k]), new_tp[k]) for k in new_tp}
        decision["decision"] = "copied"
        pe = old_proj if old_proj is not None else new_proj
        return out, pe, decision

    decision["decision"] = "folded"
    if isinstance(new_mod, CompositionalEmbedding):
        parts = module_partitions(new_mod)
        out = {}
        if new_mod.op == "concat":
            # per-partition slice folding: every table takes its dims slice
            # of the target row at its own representatives
            decision["carrier"] = "concat-all"
            off = 0
            for j, (p, d_j) in enumerate(zip(parts, new_mod.dims)):
                rows = _to_width(_old_rows(old_mod, old_tp, representative_ids(p)),
                                 old_proj, new_proj, d_new)
                out[f"table_{j}"] = _as_leaf(rows[:, off:off + d_j], new_tp[f"table_{j}"])
                off += d_j
        else:
            ci = _carrier_index(parts)
            decision["carrier"] = ci
            neutral = torch.ones if new_mod.op == "mult" else torch.zeros
            for j, p in enumerate(parts):
                key = f"table_{j}"
                if j == ci:
                    rows = _to_width(_old_rows(old_mod, old_tp, representative_ids(p)),
                                     old_proj, new_proj, d_new)
                else:
                    rows = neutral((p.num_buckets, new_mod.dims[j]), dtype=torch.float32,
                                   device=new_tp[key].device)
                out[key] = _as_leaf(rows, new_tp[key])
    else:
        # Full / Hash target: a single table whose rows 0..rows-1 are the
        # canonical ids themselves (hash folds mod m — head-injective)
        (p,) = module_partitions(new_mod)
        rows = _to_width(_old_rows(old_mod, old_tp, representative_ids(p)),
                         old_proj, new_proj, d_new)
        out = {"table": _as_leaf(rows, new_tp["table"])}

    if old_mod.out_dim == d_new and old_proj is not None:
        pe, decision["proj"] = old_proj, "carried"
    elif new_proj is not None:
        pe, decision["proj"] = new_proj, "fresh"
    else:
        pe = None
    return out, pe, decision


# ------------------------------------------------------------ whole trees

def _shapes_match(a, b) -> bool:
    la, lb = tree.leaves(a), tree.leaves(b)
    return (len(la) == len(lb)
            and all(getattr(x, "shape", None) == getattr(y, "shape", None)
                    and getattr(x, "dtype", None) == getattr(y, "dtype", None)
                    for x, y in zip(la, lb)))


def _moved(leaf, like):
    """``leaf`` on ``like``'s device (None passes)."""
    return None if leaf is None else leaf.to(like.device)


def migrate_params(old_cfg, old_params, new_cfg, new_params):
    """Warm-start a full param tree for ``new_cfg`` from ``old_params``.

    ``new_params`` is a fresh init for the new config — it supplies the
    target structure/shapes/device (and the fallback values for anything
    that cannot be carried).  Dense towers carry wholesale when their
    shapes match (F and the interaction width are unchanged across
    re-plans, so they always do in the online loop).  Returns ``(params,
    report)``; stash ``report`` in the new plan's ``notes["migration"]``
    so the swap is auditable.
    """
    from ..models.dlrm import tables_for
    if tuple(old_cfg.table_sizes) != tuple(new_cfg.table_sizes):
        raise ValueError("migration keeps the feature set: table_sizes "
                         f"{old_cfg.table_sizes} vs {new_cfg.table_sizes}")
    if old_cfg.emb_dim != new_cfg.emb_dim:
        raise ValueError("interaction width must match across plans "
                         f"({old_cfg.emb_dim} vs {new_cfg.emb_dim})")
    old_modules, new_modules = tables_for(old_cfg), tables_for(new_cfg)
    report = {"features": [], "dense": {}}
    out = {}
    for k in new_params:
        if k in ("tables", "proj"):
            continue
        if k in old_params and _shapes_match(old_params[k], new_params[k]):
            like = tree.leaves(new_params[k])
            out[k] = tree.unflatten(old_params[k], [
                _moved(x, y) for x, y in zip(tree.leaves(old_params[k]), like)])
            report["dense"][k] = "carried"
        else:
            out[k] = new_params[k]
            report["dense"][k] = "reset"
    old_proj_all = old_params.get("proj", {})
    new_proj_all = new_params.get("proj", {})
    tables, proj = [], {}
    for i, (om, nm) in enumerate(zip(old_modules, new_modules)):
        new_proj = new_proj_all.get(str(i))
        tp, pe, dec = migrate_feature(
            om, old_params["tables"][i], nm, new_params["tables"][i],
            old_proj=old_proj_all.get(str(i)), new_proj=new_proj)
        tables.append(tp)
        if nm.out_dim != new_cfg.emb_dim and pe is not None:
            proj[str(i)] = pe if new_proj is None else _moved(pe, new_proj)
        dec["feature"] = i
        report["features"].append(dec)
    out["tables"] = tables
    if proj:
        out["proj"] = proj
    kinds = [d["decision"] for d in report["features"]]
    report["counts"] = {k: kinds.count(k) for k in sorted(set(kinds))}
    return out, report


def migrate_opt_state(old_params, old_state, new_params, optimizer):
    """Carry optimizer moments across a migration, per-leaf.

    The optimizer state is a flat list in ``repro_torch.tree`` leaf order
    (``jax.tree.leaves`` order); leaves are matched by their '/'-joined
    tree path (``optim.leaf_paths``) and carried when path, shape, and
    dtype all agree — anything else (new sub-tables, changed widths)
    resets to the optimizer's ``init_leaf``.  Returns ``(state,
    decisions)`` with one ``"carried"``/``"reset"`` per new-tree path.
    """
    from ..optim.optimizers import leaf_paths
    old_by_path = dict(zip(leaf_paths(old_params),
                           zip(tree.leaves(old_params), old_state)))
    state, decisions = [], {}
    for path, leaf in zip(leaf_paths(new_params), tree.leaves(new_params)):
        prev = old_by_path.get(path)
        if (prev is not None and prev[0].shape == leaf.shape
                and prev[0].dtype == leaf.dtype):
            state.append(prev[1])
            decisions[path] = "carried"
        else:
            state.append(optimizer._rule(path).init_leaf(leaf))
            decisions[path] = "reset"
    return state, decisions

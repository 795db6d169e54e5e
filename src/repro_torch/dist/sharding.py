"""Path+shape sharding rule engine, as the JAX package's ``dist/sharding.py``.

One place decides how a tensor is laid out over the ranks of a process
group:

* ``spec_for(path, shape, mesh)`` — parameter path (``"/"``-joined,
  ``optim.optimizers.leaf_paths``) + shape → a spec: a tuple with one
  entry per dim, ``None`` or an axis name (or a tuple of names).  Rules
  are a small ordered table of ``(path regex, template)`` pairs; the first
  matching rule wins, then the template is *fitted* to the concrete shape:
  an axis group whose size does not divide a dim moves to the first free
  dim it does divide, or is dropped, so the engine never emits an invalid
  spec.  Specs compare equal to the reference's ``PartitionSpec``s.
* ``scatter_dims`` — the dims a gradient leaf can be reduce-scattered
  along (the FSDP step's plan, ``train.loop.fsdp_plan``).
* ``placement_overrides`` / ``placement_specs`` — the sharded serving
  placement's rules (``dist.serve_placement``).

A "mesh" here is its axis sizes: a ``{axis: size}`` mapping, an int (the
size of a 1-D ``data`` axis), or a ``torch.distributed`` process group
(a 1-D ``data`` axis of the group's size; ``None`` is the default group).
The engine never sees devices: a rank of the group stands where a device
of the reference's mesh stood.

``Shard`` is one rank's block of a leaf (``count`` equal blocks along
``dim``); ``ckpt.restore(shardings=)`` and the FSDP state take their
per-rank parts through it.

The reference's GSPMD side — ``constrain``, ``constrain_batch``,
``tree_shardings`` and ``set_batch_shard_axes`` — maps to DTensor
placements, which only the LM family needs (ROADMAP item 18).

Rule table (first match wins):

====================================  ==========================  =============
path pattern                          template                    example leaf
====================================  ==========================  =============
embed* / wte / tok_emb / table(s)     ("model", None)             embedding rows
lm_head / head / logits / unembed     ("model", "dp")             output head
moe / expert(s)                       ("model", "dp", None)       (E, D, F) stack
1-D / scalar leaves                   ()                          norm gains
default rank-N dense                  (None, …, "dp", "model")    mlp wi/wo
====================================  ==========================  =============
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Mapping, Optional, Sequence

import torch

__all__ = [
    "RULES", "NO_FSDP", "INFERENCE_OVERRIDES", "spec_for", "fit_template", "batch_axes",
    "scatter_dims", "placement_overrides", "placement_specs", "axis_sizes", "Shard",
    "REPLICATED",
]


# ------------------------------------------------------------------ rule table


RULES: tuple[tuple[str, tuple], ...] = (
    # Embedding / hash tables: row-sharded over `model`.
    (r"(^|/)(embed\w*|wte|tok_emb|tables?)(/|$)|(^|/)table_\d+($|/)",
     ("model", None)),
    # Output head: TP on d_model, FSDP on vocab.
    (r"(^|/)(lm_head|head|logits|unembed|out_head)(/|$)",
     ("model", "dp")),
    # Stacked expert weights (E, d_in, d_out): expert-parallel over `model`,
    # FSDP over the data group on d_in.
    (r"(^|/)(moe|experts?)(/|$)",
     ("model", "dp", None)),
)


def _default_template(rank: int) -> tuple:
    """Generic dense leaf: TP on the last dim, FSDP on the one before."""
    if rank < 2:
        return ()
    return (None,) * (rank - 2) + ("dp", "model")


# "Same rules, minus FSDP": at inference weights are read-only, so gathering
# them over the data group every step buys nothing — keep only the
# tensor-parallel placements.
NO_FSDP = "no_fsdp"
INFERENCE_OVERRIDES: tuple[tuple[str, object], ...] = ((r".*", NO_FSDP),)


def placement_overrides(placement) -> tuple[tuple[str, tuple], ...]:
    """Override rules for plan-aware serving placement: each row-sharded
    sub-table of a ``dist.serve_placement.ServePlacement`` gets a
    path-exact rule splitting its rows over ``data``; a trailing catch-all
    replicates everything else (serving weights are read-only)."""
    rules = [(rf"^{re.escape(e.path)}($|/)", ("data", None))
             for e in placement.entries if e.strategy == "row_shard"]
    rules.append((r".*", ()))
    return tuple(rules)


def placement_specs(params, placement):
    """Spec tree for serve-time placement: row-sharded sub-table leaves
    (rows padded to a multiple of N, so the fitter never relocates the
    axis) get ``("data", None)``; every other leaf replicates (a 1-D or
    scalar leaf gets ``()``)."""
    from .. import tree
    from ..optim.optimizers import leaf_paths
    overrides = placement_overrides(placement)
    sizes = {"data": placement.n_devices}
    specs = [fit_template(_template_for(p, leaf.dim(), overrides), tuple(leaf.shape), sizes,
                          batch=("data",))
             if leaf.dim() > 1 else ()
             for p, leaf in zip(leaf_paths(params), tree.leaves(params))]
    return tree.unflatten(params, specs)


# ------------------------------------------------------------------ the engine


def axis_sizes(mesh, axis: str = "data") -> dict[str, int]:
    """``{axis: size}`` of a mesh given as a mapping, an int (a 1-D mesh
    along ``axis``) or a process group (``None``: the default group, which
    must be initialized)."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    if isinstance(mesh, int):
        return {axis: mesh}
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("a process group stands for the mesh here, and none is "
                           "initialized: call torch.distributed.init_process_group first")
    return {axis: dist.get_world_size(mesh)}


def batch_axes(mesh) -> tuple[str, ...]:
    """The mesh's data-parallel axis group: every axis except ``model``."""
    return tuple(a for a in axis_sizes(mesh) if a != "model")


def _group_size(group: tuple[str, ...], sizes: dict[str, int]) -> int:
    return math.prod(sizes[a] for a in group) if group else 1


def fit_template(template: Sequence, shape: Sequence[int], sizes: dict[str, int],
                 batch: tuple[str, ...] = ("data",)) -> tuple:
    """Fit a rule template to a concrete shape given axis sizes.

    Template entries per leading dim: ``None``, ``"model"``, ``"dp"`` (the
    data-parallel group ``batch``), an axis name, or a tuple of axis names.
    Axes not in ``sizes`` are dropped.  A group whose size does not divide
    its dim is relocated to the first free dim it does divide (left to
    right), else dropped — the returned spec is always valid for ``shape``.
    """
    rank = len(shape)
    if rank <= 1:
        return ()
    resolved: list[tuple[str, ...]] = []
    for ent in list(template)[:rank]:
        if ent is None:
            resolved.append(())
            continue
        group = batch if ent == "dp" else (tuple(ent) if isinstance(ent, (tuple, list))
                                           else (ent,))
        resolved.append(tuple(a for a in group if a in sizes))
    resolved += [()] * (rank - len(resolved))

    spec: list[tuple[str, ...]] = [()] * rank
    used: set[str] = set()
    homeless: list[tuple[str, ...]] = []
    for i, group in enumerate(resolved):
        group = tuple(a for a in group if a not in used)
        if not group:
            continue
        if shape[i] > 0 and shape[i] % _group_size(group, sizes) == 0:
            spec[i] = group
            used.update(group)
        else:
            homeless.append(group)
    for group in homeless:
        group = tuple(a for a in group if a not in used)
        if not group:
            continue
        n = _group_size(group, sizes)
        for i in range(rank):
            if not spec[i] and shape[i] > 0 and shape[i] % n == 0:
                spec[i] = group
                used.update(group)
                break
    return tuple(None if not g else (g[0] if len(g) == 1 else g) for g in spec)


def _template_for(path: str, rank: int,
                  overrides: Optional[Sequence[tuple[str, object]]] = None):
    for pattern, template in tuple(overrides or ()) + RULES:
        if re.search(pattern, path):
            if template == NO_FSDP:
                base = _template_for(path, rank, overrides=None)
                return tuple(None if e == "dp" else e for e in base)
            return template
    return _default_template(rank)


def spec_for(path: str, shape: Sequence[int], mesh,
             overrides: Optional[Sequence[tuple[str, object]]] = None) -> tuple:
    """The spec of one parameter leaf.  1-D and scalar leaves replicate;
    everything else goes through the rule table and shape fitting."""
    if len(shape) <= 1:
        return ()
    sizes = axis_sizes(mesh)
    return fit_template(_template_for(path, len(shape), overrides), tuple(shape), sizes,
                        batch=batch_axes(sizes))


def scatter_dims(path: str, shape: Sequence[int], mesh, axis: str = "data") -> tuple[int, ...]:
    """Candidate reduce-scatter dims for one leaf, best first: the dim the
    rule engine assigns to ``axis`` leads (the gradient shard then has the
    layout the FSDP parameter shard would), then every other dim the axis
    size divides, left to right.  Dims it does not divide never appear."""
    shape = tuple(shape)
    sizes = axis_sizes(mesh, axis)
    n = sizes.get(axis, 1)
    spec = spec_for(path, shape, sizes)
    preferred = [i for i, ent in enumerate(spec)
                 if ent is not None and axis in (ent if isinstance(ent, tuple) else (ent,))]
    order = preferred + [i for i in range(len(shape)) if i not in preferred]
    return tuple(i for i in order if shape[i] > 0 and shape[i] % n == 0)


# ------------------------------------------------------------------ one rank's part


@dataclasses.dataclass(frozen=True)
class Shard:
    """Block ``index`` of ``count`` equal blocks of a leaf along ``dim``:
    what one rank holds of a leaf split over the group.  ``count == 1`` is
    the whole leaf (``REPLICATED``)."""

    dim: int
    index: int
    count: int

    def take(self, full: torch.Tensor) -> torch.Tensor:
        if self.count == 1:
            return full
        size = full.shape[self.dim]
        if size % self.count:
            raise ValueError(f"dim {self.dim} of {tuple(full.shape)} does not split into "
                             f"{self.count} blocks")
        block = size // self.count
        return full.narrow(self.dim, self.index * block, block)


REPLICATED = Shard(0, 0, 1)

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

The reference's GSPMD side maps to DTensor on a named ``DeviceMesh``
(``launch.mesh``), which also counts as a mesh here (its dim names and
sizes):

* ``to_placements(spec, mesh)`` — a fitted spec → one DTensor placement
  per mesh dim: a dim whose entry names axes is ``Shard(dim)`` on each of
  them, every other mesh dim ``Replicate()``.  A tuple of axes on one dim
  is split major-to-minor in the tuple's order, as JAX splits it; DTensor
  splits in the mesh's order, so an axis that the tuple puts after an axis
  that follows it in the mesh takes a ``_StridedShard`` and every mesh
  coordinate gets the reference's block.
* ``tree_shardings(structs, mesh, overrides)`` — a ``NamedSharding``
  (mesh, spec, placements) per leaf, in tree order; ``distribute`` lays a
  leaf out by one (a tensor on ``meta`` becomes a DTensor of ``meta``
  shards, allocating nothing).
* ``constrain`` / ``constrain_batch`` — in-model activation pinning: the
  identity on a plain tensor, a ``redistribute`` of a DTensor to the
  placements its entries name, under the reference's rules for dropping
  an entry.  ``replicate`` pins a DTensor whole, in front of an operation
  that has no sharding strategy; ``kernel_map`` runs a kernel wrapper on
  the local tensors.  ``set_batch_shard_axes`` / ``model_divides``
  configure them as the reference's do.

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
    "REPLICATED", "to_placements", "NamedSharding", "tree_shardings", "distribute",
    "is_dtensor", "constrain", "constrain_batch", "replicate", "replicate_dim", "settle",
    "kernel_map", "dp_entry",
    "set_batch_shard_axes", "model_divides",
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
    along ``axis``), a named ``DeviceMesh`` (its dims in order) or a
    process group (``None``: the default group, which must be
    initialized)."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    if isinstance(mesh, int):
        return {axis: mesh}
    if getattr(mesh, "mesh_dim_names", None):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
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


# ------------------------------------------------------------------ DTensor placements


def _group(ent) -> tuple[str, ...]:
    return () if ent is None else (tuple(ent) if isinstance(ent, (tuple, list)) else (ent,))


def to_placements(spec: Sequence, mesh) -> tuple:
    """One DTensor placement per dim of the named ``mesh`` for a fitted
    ``spec`` (an entry per leading tensor dim: ``None``, an axis name or a
    tuple of names).  The axes of a tuple split their dim major-to-minor
    in the tuple's order (JAX's order): an axis placed after axes that
    follow it in the mesh shards with ``_StridedShard`` by their sizes."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor import Shard as DShard
    from torch.distributed.tensor.placement_types import _StridedShard
    names = tuple(mesh.mesh_dim_names)
    sizes = axis_sizes(mesh)
    out = [Replicate()] * len(names)
    for dim, ent in enumerate(spec):
        group = _group(ent)
        for k, a in enumerate(group):
            i = names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"axis {a!r} shards two dims of spec {tuple(spec)}")
            split = math.prod(sizes[b] for b in group[:k] if names.index(b) > i)
            out[i] = _StridedShard(dim, split_factor=split) if split > 1 else DShard(dim)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's layout on a named mesh: the reference's ``NamedSharding``
    (``spec`` compares equal to its ``PartitionSpec``), with the DTensor
    placements that realise it."""

    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)


def tree_shardings(structs, mesh, overrides=None):
    """A ``NamedSharding`` per leaf of ``structs`` (tree order kept), by
    ``spec_for`` with ``overrides``."""
    from .. import tree
    from ..optim.optimizers import leaf_paths
    return tree.unflatten(structs, [NamedSharding(mesh, spec_for(p, tuple(leaf.shape), mesh,
                                                                 overrides))
                                    for p, leaf in zip(leaf_paths(structs),
                                                       tree.leaves(structs))])


def distribute(x: torch.Tensor, sharding: NamedSharding):
    """``x`` laid out as a DTensor by ``sharding``.  A tensor on ``meta``
    becomes a DTensor of this rank's ``meta`` shard (no storage, no
    collective); any other is cut locally on every rank, each rank holding
    the whole tensor (``src_data_rank=None``: nothing crosses the wire)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    placements = sharding.placements
    if x.device.type != "meta":
        return distribute_tensor(x, sharding.mesh, placements, src_data_rank=None)
    local, _ = compute_local_shape_and_global_offset(x.shape, sharding.mesh, placements)
    return DTensor.from_local(torch.empty(local, dtype=x.dtype, device="meta"), sharding.mesh,
                              placements, run_check=False, shape=x.shape, stride=x.stride())


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


# ------------------------------------------------------------------ activation pinning

# What "dp" means in ``constrain`` calls, and the model axis's size for
# ``model_divides``.  ``configs.common.lowerables`` sets both from the
# target mesh before a dry run traces a model; the defaults match a plain
# ("data", "model") mesh.
_BATCH_AXES: tuple[str, ...] = ("data",)
_MODEL_SIZE: int = 1


def set_batch_shard_axes(axes: Sequence[str], model_size: int = 1) -> None:
    """Configure the data-parallel axis group (and the model axis's size)
    that ``constrain`` / ``constrain_batch`` / ``model_divides`` use."""
    global _BATCH_AXES, _MODEL_SIZE
    _BATCH_AXES = tuple(axes) or ("data",)
    _MODEL_SIZE = max(int(model_size), 1)


def model_divides(n: int) -> bool:
    """True when ``n`` splits evenly over the model axis."""
    return n % _MODEL_SIZE == 0


def dp_entry(mesh, n: int):
    """The configured data-parallel group of ``mesh`` as a spec entry for
    a dim of size ``n`` (``constrain``'s "dp"), or None where it does not
    divide."""
    sizes = axis_sizes(mesh)
    group = tuple(a for a in _BATCH_AXES if a in sizes)
    if not group or n == 0 or n % _group_size(group, sizes):
        return None
    return group[0] if len(group) == 1 else group


def constrain(x, *axes):
    """Pin a DTensor's layout: one entry per leading dim — ``None``,
    ``"model"``, ``"dp"`` (the configured data-parallel group), an axis
    name or a tuple of names; missing trailing entries replicate.  An
    entry drops an axis its mesh lacks, and drops out whole when its
    group's size does not divide the dim or the dim is 0; with no entry
    left the call is the identity, as it is on a plain tensor — model code
    calls it unconditionally."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    sizes = axis_sizes(mesh)
    spec: list = [None] * x.dim()
    nontrivial = False
    for i, ent in enumerate(axes[:x.dim()]):
        if ent is None:
            continue
        group = tuple(a for a in (_BATCH_AXES if ent == "dp" else _group(ent)) if a in sizes)
        if not group:
            continue
        if x.shape[i] == 0 or x.shape[i] % _group_size(group, sizes):
            continue
        spec[i] = group[0] if len(group) == 1 else group
        nontrivial = True
    if not nontrivial:
        return x
    placements = to_placements(spec, mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def constrain_batch(x):
    """Pin dim 0 (the batch) to the data-parallel group; the identity on a
    plain tensor and on a scalar."""
    if not getattr(x, "ndim", 0):
        return x
    return constrain(x, "dp", *([None] * (x.dim() - 1)))


def replicate(x):
    """A DTensor whole on every rank (its ``redistribute`` to
    ``Replicate()`` on every mesh dim); the identity on a plain tensor.
    The explicit step in front of an operation that has no sharding
    strategy, so the gather it costs shows in the collectives."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    placements = (Replicate(),) * x.device_mesh.ndim
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def replicate_dim(x, dim: int):
    """A DTensor whole along ``dim``, its other splits kept (a gather over
    the mesh dims that split ``dim``); the identity on a plain tensor."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    pl = tuple(Replicate() if getattr(p, "dim", None) == dim else p for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(x.device_mesh, pl)


def settle(x):
    """A DTensor with every pending (``Partial``) reduction carried out (an
    all-reduce over those mesh dims), ahead of an in-place operation, which
    cannot change a placement; the identity on a plain tensor."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, tuple(Replicate() if p.is_partial() else p
                                               for p in x.placements))


def kernel_map(fn, batched, whole=()):
    """``fn(*batched, *whole)`` for a kernel wrapper, which takes plain
    tensors, or a lookup with no sharding strategy: the plain call when no
    argument is a DTensor.  Otherwise each of ``batched`` (dim 0 the batch)
    takes the first DTensor's dim-0 split (its other splits gathered), each
    of ``whole`` is made whole on every rank (``replicate``: the gather
    GSPMD puts around a custom call), ``fn`` runs on the local tensors, and
    its output (dim 0 the batch's) is a DTensor with the batch's split.  A
    gradient reaching a ``whole`` operand is that rank's rows' share: a
    pending sum (``Partial``) over the mesh dims that split the batch.
    ``None`` from ``fn`` passes through."""
    args = (*batched, *whole)
    if not any(is_dtensor(x) for x in args):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor import Shard as DShard
    lead = next(x for x in args if is_dtensor(x))
    mesh = lead.device_mesh
    split = next((x for x in batched if is_dtensor(x)), None)
    placements = tuple(p if isinstance(p, DShard) and p.dim == 0 else Replicate()
                       for p in (split.placements if split is not None
                                 else (Replicate(),) * mesh.ndim))

    def local(x, pl, grad_pl=None):
        if not is_dtensor(x):
            x = DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim, run_check=False)
        x = x if tuple(x.placements) == pl else x.redistribute(mesh, pl)
        return x.to_local(grad_placements=grad_pl)

    shares = tuple(Partial() if isinstance(p, DShard) else Replicate() for p in placements)
    out = fn(*(local(x, placements) for x in batched),
             *(local(x, (Replicate(),) * mesh.ndim, shares) for x in whole))
    if out is None:
        return None
    return DTensor.from_local(out, mesh, placements, run_check=False)

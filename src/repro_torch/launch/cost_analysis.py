"""Per-GPU cost of one traced call on a DTensor mesh: the port's
counterpart of the JAX package's ``launch/hlo_analysis.py``.

The reference parses the optimized HLO of a compiled SPMD program.  The
port has no HLO: the dry run (``launch.dryrun``) runs the call eagerly on
DTensors of ``meta`` shards over a fake process group, and
``CostMode`` — a dispatch mode under DTensor — sees every operation that
rank 0 runs on its local shards, with their shapes, and every collective
DTensor issues.  ``meta`` tensors have no data, so nothing is computed and
nothing is allocated.

Accounting rules (per GPU: the shapes are the local shards'):
  * **FLOPs**: ``torch.utils.flop_counter``'s formulas (matrix products,
    convolutions, attention), on the local shapes; elementwise work is not
    counted (as the reference).  DTensor's sharding propagation runs each
    new operation once more on *global* fake shapes (and caches the result
    per operator schema); those runs carry ``FakeTensor`` operands and are
    skipped, so the count is the local program's alone.
  * **Bytes**: each dispatched operation's tensor operands plus its output.
    Eager PyTorch fuses nothing, so this is what the port moves.  Views
    and allocations move nothing and are skipped; a gather / index reads
    only what it writes (2 × output, plus the indices); an in-place copy
    reads its source and writes its destination.
  * **Collective wire bytes**, ring formulas with group size n (the
    reference's): all-reduce 2·(n−1)/n · bytes, all-gather (n−1)/n · bytes
    of the result, reduce-scatter (n−1) · bytes of the result shard,
    all-to-all (n−1)/n · bytes; each with the mesh axis its group spans.
  * **Memory**: argument bytes (the local shards of the call's inputs),
    the arguments' unsharded bytes, and the peak of live bytes during the
    call (every storage alive at once: the arguments, then each new
    storage until it is freed).
  * **Kernels**: a kernel wrapper that meets ``meta`` tensors computes
    nothing (``kernels._build.meta_call``); it is counted by the bytes its
    bound counts in ``PERF.md``'s kernel table.  The reference's analysis
    skips a custom call instead (``_SKIP_BYTES``).

``analyze_hlo``'s while-loop multiplier has no counterpart: the port's
Python loops unroll, so every layer's operations are seen.
"""

from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["CostMode", "analyze_call", "wire_bytes", "tree_local_bytes"]

_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}
_GATHERS = {"embedding", "index", "index_select", "gather", "take"}
_FREE = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
         "detach", "alias", "lift_fresh", "wait_tensor", "_wrap_tensor_autograd",
         "_local_scalar_dense", "resize_", "set_", "_to_copy_meta_only"}


def wire_bytes(kind: str, nbytes: float, n: int) -> float:
    """Bytes one rank puts on the wire for a collective over a group of
    ``n``: ``nbytes`` is the all-reduced tensor, the all-gather's result,
    the reduce-scatter's result shard or the all-to-all's tensor."""
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n * nbytes
    if kind == "all-gather":
        return (n - 1) / n * nbytes
    if kind == "reduce-scatter":
        return float(n - 1) * nbytes
    if kind == "all-to-all":
        return (n - 1) / n * nbytes
    return float(nbytes)    # collective-permute


def _tensors(x) -> list:
    """The tensors in ``x`` (nested tuples / lists / dict views)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list, type({}.values()))):
        return [t for item in x for t in _tensors(item)]
    return []


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def tree_local_bytes(tree_) -> int:
    """Bytes of the local shards of every tensor in ``tree_`` (a DTensor
    counts its own shard)."""
    from torch.distributed.tensor import DTensor
    return sum(_nbytes(x.to_local() if isinstance(x, DTensor) else x)
               for x in tree_leaves(tree_) if isinstance(x, torch.Tensor))


class CostMode(TorchDispatchMode):
    """Counts rank 0's local program under DTensor (see the module
    docstring).  ``axis_of`` maps a process group's name to the mesh axis
    name(s) it spans."""

    def __init__(self, axis_of: dict[str, str]):
        super().__init__()
        self.axis_of = axis_of
        self.flops = 0.0
        self.bytes = 0.0
        self.wire = 0.0
        self.collectives: dict = defaultdict(lambda: {"count": 0, "wire_bytes": 0.0})
        self.wire_by_axis: dict = defaultdict(float)
        self.kernels: dict = defaultdict(lambda: {"calls": 0, "bytes": 0})
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._seen: set[int] = set()

    # -------------------------------------------------------------- memory

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it is freed."""
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self._seen:
            return
        self._seen.add(key)
        n = storage.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live -= n

    # -------------------------------------------------------------- kernels

    def kernel(self, name: str, nbytes: int) -> None:
        self.kernels[name]["calls"] += 1
        self.kernels[name]["bytes"] += nbytes
        self.bytes += nbytes

    # -------------------------------------------------------------- dispatch

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        operands = _tensors((args, kwargs.values()))
        outs = _tensors(out)
        if any(type(x) is FakeTensor for x in operands + outs):
            return out      # DTensor's sharding propagation on global shapes
        self.ops += 1
        for x in outs:
            self.track(x)
        name = func._schema.name.split("::")[-1]
        ns = func.namespace
        if ns in ("_c10d_functional", "_c10d_functional_autograd", "c10d"):
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                group = [a for a in args if isinstance(a, str)][-1]   # the group's name
                axis, n = self.axis_of.get(group, (group, 1))
                nbytes = _nbytes(outs[0]) if outs else _nbytes(operands[0])
                w = wire_bytes(kind, nbytes, n)
                self.wire += w
                self.wire_by_axis[axis] += w
                self.collectives[kind]["count"] += 1
                self.collectives[kind]["wire_bytes"] += w
            return out
        if name in _FREE or func.is_view:
            return out
        from torch.utils.flop_counter import flop_registry
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if name in _GATHERS:
            idx = sum(_nbytes(x) for x in operands if not x.is_floating_point())
            self.bytes += idx + 2 * sum(_nbytes(x) for x in outs)
        elif name.startswith("copy_"):
            self.bytes += 2 * _nbytes(operands[1] if len(operands) > 1 else operands[0])
        else:
            self.bytes += sum(_nbytes(x) for x in operands) + sum(_nbytes(x) for x in outs)
        return out


def _axis_of(mesh) -> dict:
    """Process-group name → (mesh axis name, group size) for every mesh dim."""
    out = {}
    for i, name in enumerate(mesh.mesh_dim_names):
        out[mesh.get_group(i).group_name] = (name, mesh.size(i))
    return out


def analyze_call(fn, args, mesh) -> dict:
    """Run ``fn(*args)`` (DTensors of ``meta`` shards on ``mesh``) under
    ``CostMode`` with plain tensors taken as replicated
    (``implicit_replication``: an index range or a mask built inside a
    model is made on every rank), and return rank 0's per-GPU record:
    ``flops_per_chip``, ``hbm_bytes_per_chip``,
    ``collective_wire_bytes_per_chip`` (and by axis), ``collectives``,
    ``kernels`` (the wrappers' ``meta`` calls), ``memory_analysis``
    (``argument_size_in_bytes``, ``peak_live_bytes``,
    ``unsharded_argument_bytes``) and the number of local operations
    dispatched."""
    from torch.distributed.tensor.experimental import implicit_replication

    from ..kernels import _build
    from torch.distributed.tensor import DTensor
    mode = CostMode(_axis_of(mesh))
    arg_bytes = tree_local_bytes(args)
    whole_bytes = sum(_nbytes(x) for x in tree_leaves(args) if isinstance(x, torch.Tensor))
    for x in tree_leaves(args):
        if isinstance(x, torch.Tensor):
            mode.track(x.to_local() if isinstance(x, DTensor) else x)
    _build.meta_observers.append(mode.kernel)
    try:
        # a train step enables grad itself (``train.loop.value_and_grad``)
        with mode, implicit_replication(), torch.no_grad():
            result = fn(*args)
        del result
    finally:
        _build.meta_observers.remove(mode.kernel)
    return {
        "flops_per_chip": mode.flops,
        "hbm_bytes_per_chip": mode.bytes,
        "collective_wire_bytes_per_chip": mode.wire,
        "collective_wire_bytes_by_axis": dict(mode.wire_by_axis),
        "collectives": {k: dict(v) for k, v in mode.collectives.items()},
        "kernels": {k: dict(v) for k, v in mode.kernels.items()},
        "local_ops": mode.ops,
        "memory_analysis": {"argument_size_in_bytes": arg_bytes,
                            "peak_live_bytes": mode.peak,
                            "unsharded_argument_bytes": whole_bytes},
    }


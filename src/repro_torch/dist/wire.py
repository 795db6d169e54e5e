"""The collectives of the multi-process paths, each counting the bytes it
hands over: the port's counterpart of the reference's HLO cross-check
(``launch.hlo_analysis.analyze_hlo`` on the compiled step or wave).

Every collective that ``compress``, the data-parallel and FSDP steps
(``train.loop``), the FSDP checkpoint gather, the sharded serving
exchange (``serve_placement.exchange_rows``) and the sharded engine issue
goes through the thin functions here.  Each call adds the
per-device ring bytes of the tensor it really hands over — its
``numel() × element_size()``, through the ``accounting`` formula of its
call kind — to the process's log (``LOG``; one per process, as each rank
is a process, like the kernels' launch counters), by call kind and by
leaf; ``reset()`` clears it and ``snapshot()`` reads it.  The closed
forms in ``accounting`` are computed from shapes and modes; these are
counted from tensors, so ``benchmarks/dist_bench.py`` can hold the one
to the other.

Layouts are those of the reference's ``lax`` collectives:

* ``all_to_all`` — ``x`` of shape ``(n, k)``: row ``r`` goes to rank
  ``r``, and row ``r`` of the result came from rank ``r``
  (``lax.all_to_all(split_axis=0, concat_axis=0)``);
* ``all_gather`` — every rank's ``x`` concatenated along ``dim`` (0 by
  default) in rank order (``lax.all_gather(axis=dim, tiled=True)``),
  through the list form of
  ``torch.distributed.all_gather``, which NCCL and gloo both take for
  CPU and CUDA tensors;
* ``all_reduce`` — ``"sum"`` or ``"max"`` (``psum`` / ``pmax``).

Each returns a new tensor and leaves its input as it was.  bf16 payloads
cross as ``torch.bfloat16`` (2 B per element; the reference sends uint16
bits because XLA CPU widens bf16 collectives, and gloo has no 16-bit
integer type).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from . import accounting

__all__ = ["KINDS", "WireLog", "LOG", "reset", "snapshot", "all_to_all", "all_gather",
           "all_reduce"]

KINDS = ("all_to_all", "all_gather", "all_reduce")
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class WireLog:
    """Calls and ring bytes per call kind, and bytes per leaf."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls = {k: 0 for k in KINDS}
        self.bytes = {k: 0.0 for k in KINDS}
        self.leaf_bytes: dict[str, float] = {}
        self.leaf_calls: dict[str, int] = {}

    def record(self, kind: str, leaf: str, nbytes: float) -> None:
        self.calls[kind] += 1
        self.bytes[kind] += nbytes
        self.leaf_bytes[leaf] = self.leaf_bytes.get(leaf, 0.0) + nbytes
        self.leaf_calls[leaf] = self.leaf_calls.get(leaf, 0) + 1

    def snapshot(self) -> dict:
        return {"total_bytes": sum(self.bytes.values()),
                "calls": sum(self.calls.values()),
                "per_kind": {k: {"calls": self.calls[k], "bytes": self.bytes[k]}
                             for k in KINDS},
                "per_leaf": dict(self.leaf_bytes),
                "per_leaf_calls": dict(self.leaf_calls)}


LOG = WireLog()


def reset() -> None:
    LOG.reset()


def snapshot() -> dict:
    return LOG.snapshot()


def _nbytes(x: torch.Tensor) -> float:
    return float(x.numel() * x.element_size())


def all_to_all(x: torch.Tensor, group, *, leaf: str = "_unnamed") -> torch.Tensor:
    """Row ``r`` of ``x`` (shape ``(n, k)``) to rank ``r``; the result's
    row ``r`` is rank ``r``'s."""
    n = dist.get_world_size(group)
    if x.dim() != 2 or x.shape[0] != n:
        raise ValueError(f"all_to_all takes an (n, k) tensor for n={n}, got {tuple(x.shape)}")
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    LOG.record("all_to_all", leaf, accounting.ring_all_to_all_bytes(_nbytes(x), n))
    return out


def all_gather(x: torch.Tensor, group, *, dim: int = 0,
               leaf: str = "_unnamed") -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, in rank order."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    LOG.record("all_gather", leaf, accounting.ring_all_gather_bytes(n * _nbytes(x), n))
    return torch.cat(parts, dim=dim)


def all_reduce(x: torch.Tensor, group, *, op: str = "sum",
               leaf: str = "_unnamed") -> torch.Tensor:
    """The elementwise sum or max of every rank's ``x``."""
    n = dist.get_world_size(group)
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=_OPS[op], group=group)
    LOG.record("all_reduce", leaf, accounting.ring_all_reduce_bytes(_nbytes(x), n))
    return out

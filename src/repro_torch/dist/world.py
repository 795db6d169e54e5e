"""A world of processes on one host for ``torch.distributed``: join one
from a store, or spawn one.

``spawn(fn, world, backend, *args)`` starts ``world`` processes with the
``spawn`` start method (never ``fork``: the parent may hold CUDA or other
threads), joins them in one process group through a ``FileStore`` in a
fresh temporary directory (no fixed port, so worlds started at once do
not collide), runs ``fn(rank, world, *args)`` in each and tears the group
down.  A worker's exception fails the call (``torch.multiprocessing.spawn``
raises it).  ``fn`` must be importable by name (a module-level function).

``local(backend)`` makes a process group of one, in memory, for a
process started alone (the training launcher without ``torchrun``).  With
``nccl`` a rank binds its current CUDA device.
"""

from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist

__all__ = ["local", "spawn"]


def _join(rank: int, world: int, backend: str, store) -> None:
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, store=store, rank=rank, world_size=world, **kw)


def local(backend: str) -> None:
    """A process group of one (rank 0), its store in memory."""
    _join(0, 1, backend, dist.HashStore())


def _entry(rank, fn, world, backend, store_path, args):
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    _join(rank, world, backend, dist.FileStore(store_path, world))
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, backend: str, *args) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes joined
    in one ``backend`` process group."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="repro_torch_world_") as d:
        mp.spawn(_entry, args=(fn, world, backend, os.path.join(d, "store"), args),
                 nprocs=world, join=True)

"""Production meshes for the H100, and the figures the roofline reads.

Functions, not module-level constants: importing this module starts no
process group.

Production target: H100 SXM nodes of 8 GPUs joined all to all by NVLink,
the nodes joined by the network.  Tensor parallelism (``model``) stays
inside one node's NVLink domain, as H100 deployments run it; the data axes
(``data``, and ``pod`` across two clusters) cross the network.

  single pod : (data=32, model=8)            — 256 GPUs, ``pod_32x8``
  multi-pod  : (pod=2, data=32, model=8)     — 512 GPUs, ``multipod_2x32x8``

These have the device counts of the JAX package's ``pod_16x16`` and
``multipod_2x16x16`` (``repro/launch/mesh.py``); the split differs
because a TPU's 16-wide ICI ring has no counterpart here.

A production mesh lives on a ``fake`` process group of its size in this
one process (``torch.testing._internal.distributed.fake_pg``): each
collective returns at once and moves nothing, so DTensors of ``meta``
shards trace rank 0's per-GPU program (``launch.dryrun``) on any machine,
with no GPU.
"""

from __future__ import annotations

import math

__all__ = ["HW", "MESHES", "fake_mesh", "make_production_mesh", "make_local_mesh", "mesh_name"]

# Figures of one H100 SXM (the hopper-kernels guide, from NVIDIA's data
# sheet: dense rates, full 700 W power limit).
HW = {
    "peak_bf16_flops": 989e12,   # tensor cores, dense, per GPU
    "hbm_bw": 3.35e12,           # bytes/s per GPU
    "nvlink_bw": 450e9,          # bytes/s per GPU each way, to the node's other GPUs
    # Assumption, no measurement: one 400 Gb/s NDR InfiniBand port per GPU
    # (ConnectX-7, as in a DGX H100) = 50e9 bytes/s each way.  No run on
    # one card can measure it.
    "network_bw": 50e9,
    "hbm_per_gpu": 80e9,
}

# mesh name -> (axis sizes, axis names)
MESHES = {
    "pod_32x8": ((32, 8), ("data", "model")),
    "multipod_2x32x8": ((2, 32, 8), ("pod", "data", "model")),
}


def mesh_name(multi_pod: bool) -> str:
    return "multipod_2x32x8" if multi_pod else "pod_32x8"


def _fake_world(n: int) -> None:
    """A ``fake`` default process group of ``n`` ranks, this process rank 0
    (a fake group of another size is replaced; any other group refused)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} process group is running: a production "
                               "mesh needs the process to itself (it starts a fake group)")
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), world_size=n, rank=0)


def fake_mesh(shape, names):
    """A named ``DeviceMesh`` of ``shape`` on a fake process group of its
    size, this process rank 0."""
    from torch.distributed.device_mesh import init_device_mesh
    _fake_world(math.prod(shape))
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    """The production ``DeviceMesh`` on a fake process group of its size."""
    return fake_mesh(*MESHES[mesh_name(multi_pod)])


def make_local_mesh(data: int = 1, model: int = 1):
    """A ``(data, model)`` mesh over the running process group (which must
    have ``data * model`` ranks): on the card under NCCL, else on the CPU."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh builds over a running process group: call "
                           "torch.distributed.init_process_group first")
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device, (data, model), mesh_dim_names=("data", "model"))

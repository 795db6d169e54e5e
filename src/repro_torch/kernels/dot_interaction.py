"""DLRM pairwise dot interaction: the packed strict lower triangle of
``X·Xᵀ`` per example, f32 accumulation, output in ``x``'s dtype — for a
stacked ``x (B, F, D)`` (``dot_interaction``), or for ``X = [z; feats]``
read in place, written straight into the top MLP's input ``[z, triangle]``
(``dot_interaction_concat``).

Kernel: ``csrc/dot_interaction.cu`` (CUDA C++ for sm_90a), replacing the
Pallas TPU kernel ``repro/kernels/dot_interaction.py::dot_interaction``;
both entries launch it.

Bound on the card: latency and bytes.  At F=27, D=16 an example reads
1.7 KB and writes 351 outputs with under 4 flops per byte moved, and a
batch of 256 is one launch plus a couple of dependent memory round trips.
``EXAMPLES_PER_BLOCK`` examples share a block of 128 threads; the block
stages them once in shared memory at a padded stride (no bank conflicts),
maps each packed output to its (i, j) through a table built once per block,
and its threads each compute several neighbouring outputs.  The TPU's batch
block of 8 (and the padding it needed) has no counterpart.

For CPU tensors the wrappers return the plain versions
(``kernels/ref.py``); for CUDA tensors they launch the kernel or raise.
``dot_interaction.launches`` counts the launches of both entries.
"""

from __future__ import annotations

import torch

from ..obs.trace import span
from . import _build, ref

__all__ = ["EXAMPLES_PER_BLOCK", "dot_interaction", "dot_interaction_concat"]

# Examples per block of 128 threads: of 1, 2, 4 and 8, 1 timed fastest on
# the H100 at B=256, F=27, D=16 (PERF.md, the K2 sweep): at this size more
# blocks beat fewer, longer ones.  Fewer where shared memory is short.
EXAMPLES_PER_BLOCK = 1
_SMEM_MAX = 232448       # a block's shared memory on the H100


def _launch(name, z, feats, out, z_cols):
    """Check ``z (B, D)`` and ``feats (B, T, D)``, launch the kernel into
    ``out`` (rows of ``z_cols`` z columns, then the packed pairs), in one
    ``repro.launch`` span."""
    with span("repro.launch", kernel=name, rows=feats.shape[0]):
        _build.refuse_grad(name, (z, feats))
        device = z.device
        if z.dtype not in (torch.float32, torch.bfloat16) or feats.dtype != z.dtype:
            raise ValueError(f"{name}: z and feats are f32 or bf16 alike, got {z.dtype} and "
                             f"{feats.dtype}")
        b, t, d = feats.shape
        f = t + 1
        pairs = f * (f - 1) // 2
        e = EXAMPLES_PER_BLOCK
        while e > 1 and 4 * (pairs + e * f * (d + 1)) > _SMEM_MAX:
            e //= 2
        smem = 4 * (pairs + e * f * (d + 1))
        if smem > _SMEM_MAX:
            raise ValueError(f"{name}: F={f}, D={d} need {smem} B of shared memory per block, "
                             f"over {_SMEM_MAX}")
        if device.type == "meta":
            return _build.meta_call(name, sum(t.numel() * t.element_size()
                                              for t in (z, feats, out)), out)
        if b == 0 or out.shape[1] == 0:
            return out
        code = _build.library("dot_interaction").dot_interaction(
            z.data_ptr(), *z.stride(), feats.data_ptr(), *feats.stride(), out.data_ptr(),
            out.stride(0), z_cols, b, t, d, int(z.dtype == torch.bfloat16), e, smem,
            torch.cuda.current_stream(device).cuda_stream)
        _build.check("dot_interaction", code, f"{name} launch")
        dot_interaction.launches += 1
        return out


def dot_interaction(x):
    """Packed strictly-lower triangle of batched ``X·Xᵀ``: ``x (B, F, D)``
    f32 or bf16 → ``(B, F*(F-1)//2)`` in ``x``'s dtype."""
    device = _build.launch_device(x)
    if device is None:
        return ref.dot_interaction(x)
    if x.dim() != 3 or x.shape[1] == 0:
        raise ValueError(f"dot_interaction takes (B, F, D) with F >= 1, got {tuple(x.shape)}")
    b, f, _ = x.shape
    out = torch.empty((b, f * (f - 1) // 2), dtype=x.dtype, device=device)
    return _launch("dot_interaction", x[:, 0], x[:, 1:], out, 0)


def dot_interaction_concat(z, feats):
    """The top MLP's input for ``X = [z; feats]``: ``z (B, D)`` and
    ``feats (B, T, D)``, f32 or bf16 alike, any strides → ``(B, D +
    F*(F-1)//2)`` with ``z`` in the first ``D`` columns and the packed
    triangle of ``X·Xᵀ`` after them (``F = T + 1``)."""
    device = _build.launch_device(z, feats)
    if device is None:
        return ref.dot_interaction_concat(z, feats)
    if z.dim() != 2 or feats.dim() != 3 or feats.shape[0] != z.shape[0] \
            or feats.shape[2] != z.shape[1]:
        raise ValueError(f"dot_interaction_concat takes z (B, D) and feats (B, T, D), got "
                         f"{tuple(z.shape)} and {tuple(feats.shape)}")
    b, t, d = feats.shape
    out = torch.empty((b, d + (t + 1) * t // 2), dtype=z.dtype, device=device)
    return _launch("dot_interaction_concat", z, feats, out, d)


dot_interaction.launches = 0

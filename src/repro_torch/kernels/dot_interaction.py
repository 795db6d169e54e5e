"""DLRM pairwise dot interaction: ``(B, F, D) → (B, F(F-1)/2)``, the packed
strict lower triangle of ``X·Xᵀ`` per example, f32 accumulation, output in
``x``'s dtype.

Kernel: ``csrc/dot_interaction.cu`` (CUDA C++ for sm_90a), replacing the
Pallas TPU kernel ``repro/kernels/dot_interaction.py::dot_interaction``.

Bound on the card: memory.  At F=27, D=16 an example reads 1.7 KB of f32
and writes 351 outputs with under 4 flops per byte moved, so the least
time is the bytes over the card's memory rate.  The design gives one
block to each example, stages ``x[b]`` in shared memory once and writes
each packed output once from neighbouring threads; the TPU's batch block
of 8 (and the padding it needed) has no counterpart.

For CPU tensors the wrapper returns the plain version
(``kernels/ref.py``); for CUDA tensors it launches the kernel or raises.
``dot_interaction.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import _build, ref

__all__ = ["dot_interaction"]


def dot_interaction(x):
    """Packed strictly-lower triangle of batched ``X·Xᵀ``: ``x (B, F, D)``
    f32 or bf16 → ``(B, F*(F-1)//2)`` in ``x``'s dtype."""
    device = _build.launch_device(x)
    if device is None:
        return ref.dot_interaction(x)
    if x.dim() != 3 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dot_interaction takes (B, F, D) f32/bf16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    b, f, d = x.shape
    if 4 * f * d > 232448:
        raise ValueError(f"dot_interaction: F*D = {f * d} exceeds a block's shared memory")
    x = x.contiguous()
    out = torch.empty((b, f * (f - 1) // 2), dtype=x.dtype, device=device)
    if b == 0 or out.shape[1] == 0:
        return out
    code = _build.library("dot_interaction").dot_interaction(
        x.data_ptr(), out.data_ptr(), b, f, d, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(device).cuda_stream)
    _build.check("dot_interaction", code, "dot_interaction launch")
    dot_interaction.launches += 1
    return out


dot_interaction.launches = 0

"""Kernel microbenchmarks on the card: device time per call of each
kernel's entry point and of its plain version (``kernels/ref.py``), at
the JAX package's kernel-bench shapes, with its analytic bytes and
operations in ``derived``: unfused QR bag = 3·L·D reads/writes per pooled
row vs fused = 2·L·D reads + D writes.

Times come from CUDA events over calls queued ahead of the device
(``timing.device_ms``), in µs.  Every kernel row also holds the kernel's
output against its plain version's (``max_abs_err``).  The bench needs a
card: on another device it raises.
"""

from __future__ import annotations

import torch

from .timing import device_ms

__all__ = ["rows"]


def _us(fn, iters=200) -> float:
    return device_ms(fn, iters) * 1e3


def _err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def rows(device="cuda"):
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"the kernel bench times CUDA kernels with CUDA events; "
                           f"device {device} is no card")
    from ..kernels import ops, ref

    gen = torch.Generator(device=device).manual_seed(0)
    out = []
    m, q, d = 2048, 16, 128
    wr = torch.randn((m, d), generator=gen, device=device)
    wq = torch.randn((q, d), generator=gen, device=device)
    n = 512
    idx = torch.randint(0, m * q, (n,), generator=gen, device=device, dtype=torch.int32)

    def ref_gather():
        return ref.qr_gather(idx % m, idx // m, wr, wq)

    bytes_unfused = n * d * 4 * 3  # two gathered rows written + read + result
    out.append(("kernel/qr_gather/ref_torch", _us(ref_gather),
                f"hbm_bytes_unfused={bytes_unfused}"))
    err = _err(ops.qr_lookup(idx, wr, wq), ref_gather())
    bytes_fused = n * d * 4 * 2 + n * d * 4  # reads + single write
    out.append(("kernel/qr_gather/cuda", _us(lambda: ops.qr_lookup(idx, wr, wq)),
                f"hbm_bytes_fused={bytes_fused};max_abs_err={err}"))

    b, length = 32, 8
    idx2 = torch.randint(0, m * q, (b, length), generator=gen, device=device,
                         dtype=torch.int32)
    mask = torch.ones((b, length), device=device)

    def ref_bag():
        return ref.qr_embedding_bag(idx2 % m, idx2 // m, mask, wr, wq)

    out.append(("kernel/qr_bag/ref_torch", _us(ref_bag),
                f"hbm_bytes_unfused={b * length * d * 4 * 3 + b * d * 4}"))
    err = _err(ops.qr_bag_lookup(idx2, mask, wr, wq), ref_bag())
    out.append(("kernel/qr_bag/cuda", _us(lambda: ops.qr_bag_lookup(idx2, mask, wr, wq)),
                f"hbm_bytes_fused={b * length * d * 4 * 2 + b * d * 4};max_abs_err={err}"))

    x = torch.randn((256, 27, 16), generator=gen, device=device)
    flops = 2 * 256 * 27 * 27 * 16
    out.append(("kernel/dot_interact/ref_torch", _us(lambda: ref.dot_interaction(x)),
                f"flops={flops}"))
    err = _err(ops.dlrm_interact(x), ref.dot_interaction(x))
    out.append(("kernel/dot_interact/cuda", _us(lambda: ops.dlrm_interact(x)),
                f"flops={flops};max_abs_err={err}"))
    return out

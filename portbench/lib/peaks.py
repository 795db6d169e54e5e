"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at its full 700 W power limit)."""

from __future__ import annotations

H100 = {
    "f32_flops": 67e12,        # float32 outside the tensor cores
    "tf32_flops": 495e12,
    "bf16_flops": 989e12,
    "hbm_bytes_per_s": 3.35e12,
    "memory_bytes": 80e9,
}


def for_device(kind: str) -> dict:
    """The peaks of the card named ``kind`` (``torch.cuda.get_device_name``)."""
    if "H100" in kind:
        return H100
    raise ValueError(f"no table of peaks for {kind!r}")

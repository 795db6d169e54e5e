"""The synthetic Criteo stream, frozen as the benchmark's yardstick.

A copy of ``repro_torch/data/criteo.py``'s ``KAGGLE_TABLE_SIZES`` and
``batch_at``, kept here so that a change to the program never changes the
traffic it is measured on:

  * stateless per ``(seed, step)``: one ``torch.Generator`` on the device,
    seeded by ``zlib.crc32`` of ``"{seed}:step:{step}"``, draws the dense
    features, the id uniforms and the label noise, in that order;
  * categorical ids are power-law, ``min(floor(S·u^zipf), S−1)``;
  * labels come from a planted logistic model,
    ``dense·w_d + Σ sin(sparse·c)·a + noise·N(0, 1) > 0``, whose weights
    are drawn on the CPU from generators seeded by ``zlib.crc32`` tags.
"""

from __future__ import annotations

import dataclasses
import zlib

import torch

__all__ = ["KAGGLE_TABLE_SIZES", "CriteoSpec", "batch_at"]

# Criteo Kaggle per-feature cardinalities (rounded, public statistics).
KAGGLE_TABLE_SIZES = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145,
    5683, 8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4,
    7046547, 18, 15, 286181, 105, 142572,
)


@dataclasses.dataclass(frozen=True)
class CriteoSpec:
    table_sizes: tuple[int, ...] = KAGGLE_TABLE_SIZES
    dense_dim: int = 13
    zipf: float = 1.5          # idx = floor(S * u^zipf): higher = more skew
    noise: float = 0.5


def _step_seed(seed: int, step: int, tag: str = "step") -> int:
    return zlib.crc32(f"{seed}:{tag}:{step}".encode())


def _planted(seed: int, tag: str, shape):
    gen = torch.Generator().manual_seed(zlib.crc32(f"{seed}:{tag}".encode()) % (2 ** 31))
    return torch.randn(shape, generator=gen) / shape[0] ** 0.5


def batch_at(seed: int, step: int, batch_size: int, spec: CriteoSpec, device="cuda"):
    """Deterministic batch for ``(seed, step)`` on ``device``: ``dense``
    f32 ``(B, dense_dim)``, ``sparse`` int32 ``(B, n_tables)``, ``label``
    f32 ``(B,)`` in {0, 1}."""
    gen = torch.Generator(device=device).manual_seed(_step_seed(seed, step))
    dense = torch.randn((batch_size, spec.dense_dim), generator=gen, device=device)
    u = torch.rand((batch_size, len(spec.table_sizes)), generator=gen, device=device)
    noise = torch.randn((batch_size,), generator=gen, device=device)
    sizes = torch.tensor(spec.table_sizes, dtype=torch.float32, device=device)
    sparse = torch.minimum(torch.floor(u ** spec.zipf * sizes), sizes - 1).to(torch.int32)
    n_tab = len(spec.table_sizes)
    w_dense = _planted(seed, "wd", (spec.dense_dim,)).to(device)
    a = _planted(seed, "a", (n_tab,)).to(device)
    c = _planted(seed, "c", (n_tab,)).to(device) * 5.0
    score = dense @ w_dense + torch.sum(torch.sin(sparse * c) * a, dim=-1)
    label = (score + spec.noise * noise > 0).to(torch.float32)
    return {"dense": dense, "sparse": sparse, "label": label}

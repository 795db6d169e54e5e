"""Criteo-format data: the Kaggle table sizes and a seeded synthetic stream.

``batch_at(seed, step, ...)`` keeps the reference generator's contract
without its bits (``jax.random`` draws cannot be reproduced in torch):

  * stateless per ``(seed, step)``: a restarted run replays the exact
    stream, and any step can be drawn alone;
  * categorical ids are power-law, ``min(floor(S·u^zipf), S−1)`` for
    ``u ~ U[0, 1)``, so the share of a feature's draws below ``t·S`` is
    ``t^(1/zipf)``;
  * labels come from a planted logistic model over the dense features and
    low-order harmonics of the category ids, ``score + noise·N(0, 1) > 0``
    with ``score = dense·w_d + Σ sin(sparse·c)·a``.  The planted weights
    are drawn on the CPU from a generator seeded by the same ``zlib.crc32``
    tag as the reference's, so the planted task is the same on every
    device.

The batch is drawn on ``device`` from a ``torch.Generator`` there.  Tests
that compare the port with the reference take the reference's batches
across as numpy arrays.
"""

from __future__ import annotations

import dataclasses
import zlib

import torch

__all__ = ["CriteoSpec", "KAGGLE_TABLE_SIZES", "batch_at"]

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
    zipf: float = 3.0          # idx = floor(S * u^zipf): higher = more skew
    noise: float = 1.0


def _step_seed(seed: int, step: int) -> int:
    """One generator seed per ``(seed, step)`` pair, in the 32 bits a CPU
    ``torch.Generator`` keeps of its seed.  CRC-32 tells apart any two tags
    of one length that differ within 4 bytes, so neighbouring steps never
    share a seed."""
    return zlib.crc32(f"{seed}:step:{step}".encode())


def batch_at(seed: int, step: int, batch_size: int, spec: CriteoSpec, device="cuda"):
    """Deterministic batch for ``(seed, step)`` on ``device``: ``dense``
    f32 ``(B, dense_dim)``, ``sparse`` int32 ``(B, n_tables)``, ``label``
    f32 ``(B,)`` in {0, 1}."""
    gen = torch.Generator(device=device).manual_seed(_step_seed(seed, step))
    n_tab = len(spec.table_sizes)
    dense = torch.randn((batch_size, spec.dense_dim), generator=gen, device=device)
    u = torch.rand((batch_size, n_tab), generator=gen, device=device)
    noise = torch.randn((batch_size,), generator=gen, device=device)
    sizes = torch.tensor(spec.table_sizes, dtype=torch.float32, device=device)
    sparse = torch.minimum(torch.floor(u ** spec.zipf * sizes), sizes - 1).to(torch.int32)

    w_dense = _planted(seed, "wd", (spec.dense_dim,)).to(device)
    a = _planted(seed, "a", (n_tab,)).to(device)
    c = _planted(seed, "c", (n_tab,)).to(device) * 5.0
    score = dense @ w_dense + torch.sum(torch.sin(sparse * c) * a, dim=-1)
    label = (score + spec.noise * noise > 0).to(torch.float32)
    return {"dense": dense, "sparse": sparse, "label": label}


def _planted(seed: int, tag: str, shape):
    # zlib.crc32, not hash(): Python's string hash is salted per process
    gen = torch.Generator().manual_seed(zlib.crc32(f"{seed}:{tag}".encode()) % (2 ** 31))
    return torch.randn(shape, generator=gen) / shape[0] ** 0.5

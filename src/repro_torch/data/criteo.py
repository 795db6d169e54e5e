"""Criteo-format data: the Kaggle table sizes and the stream's shape.

The seeded synthetic batch generator arrives with the training slice.
"""

from __future__ import annotations

import dataclasses

__all__ = ["CriteoSpec", "KAGGLE_TABLE_SIZES"]

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

"""Complementary partitions of a category set (paper §3).

A partition of ``S = {0, ..., size-1}`` is represented by a bucketing
function ``idx -> bucket`` with ``num_buckets`` buckets; equivalence classes
are the preimages of buckets.  A family ``P_1..P_k`` is *complementary*
(Definition 1) iff the code tuple ``x -> (p_1(x), ..., p_k(x))`` is
injective on S — i.e. any two distinct categories land in different buckets
under at least one partition.

``bucket`` takes an integer tensor (or anything ``torch.as_tensor``
accepts: numpy arrays, Python ints) and returns a tensor on the same
device.  Indices are non-negative, so ``//`` and ``%`` agree with the
reference's floor division and modulus.
"""

from __future__ import annotations

import dataclasses
import math
from functools import reduce
from typing import Sequence

import numpy as np
import torch

__all__ = [
    "Partition",
    "RemainderPartition",
    "QuotientPartition",
    "GeneralizedQRPartition",
    "ExplicitPartition",
    "naive_partition",
    "qr_partitions",
    "generalized_qr_partitions",
    "crt_partitions",
    "is_complementary",
    "codes_for",
    "min_collision_free_m",
]


@dataclasses.dataclass(frozen=True)
class Partition:
    """Base class: a partition of {0..size-1} into ``num_buckets`` buckets."""

    size: int
    num_buckets: int

    def bucket(self, idx):  # pragma: no cover - abstract
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class RemainderPartition(Partition):
    """``p(x) = x mod m`` (paper §3.1 ex. 2, the 'hashing trick' partition)."""

    m: int = 1

    def bucket(self, idx):
        return torch.as_tensor(idx) % self.m


@dataclasses.dataclass(frozen=True)
class QuotientPartition(Partition):
    """``p(x) = x \\ m`` (integer division; paper §3.1 ex. 2)."""

    m: int = 1

    def bucket(self, idx):
        return torch.as_tensor(idx) // self.m


@dataclasses.dataclass(frozen=True)
class GeneralizedQRPartition(Partition):
    """``p(x) = (x \\ M_j) mod m_j`` — mixed-radix digit (paper §3.1 ex. 3)."""

    divisor: int = 1  # M_j = prod_{i<j} m_i
    modulus: int = 1  # m_j

    def bucket(self, idx):
        return (torch.as_tensor(idx) // self.divisor) % self.modulus


@dataclasses.dataclass(frozen=True)
class ExplicitPartition(Partition):
    """Partition given by an explicit bucket table (e.g. car make/year).

    ``table[i]`` is the bucket of category ``i``; the table lives on the
    host as numpy and moves to the index's device per call.
    """

    table: np.ndarray = None  # type: ignore[assignment]

    def bucket(self, idx):
        idx = torch.as_tensor(idx)
        return torch.as_tensor(self.table, device=idx.device)[idx.long()]


def naive_partition(size: int) -> list[Partition]:
    """Singleton partition — full embedding table (paper §3.1 ex. 1)."""
    return [GeneralizedQRPartition(size=size, num_buckets=size, divisor=1, modulus=size)]


def qr_partitions(size: int, m: int) -> list[Partition]:
    """Quotient–remainder pair (paper §2 / §3.1 ex. 2): a remainder table
    of ``m`` rows and a quotient table of ``ceil(size/m)`` rows."""
    if not (1 <= m <= size):
        raise ValueError(f"m={m} must be in [1, size={size}]")
    q = math.ceil(size / m)
    return [
        RemainderPartition(size=size, num_buckets=m, m=m),
        QuotientPartition(size=size, num_buckets=q, m=m),
    ]


def generalized_qr_partitions(size: int, ms: Sequence[int]) -> list[Partition]:
    """Mixed-radix decomposition into k digits (paper §3.1 ex. 3)."""
    ms = list(ms)
    if reduce(lambda a, b: a * b, ms, 1) < size:
        raise ValueError(f"prod({ms}) < size={size}: partitions not complementary")
    parts: list[Partition] = []
    divisor = 1
    for m in ms:
        parts.append(
            GeneralizedQRPartition(size=size, num_buckets=m, divisor=divisor, modulus=m)
        )
        divisor *= m
    return parts


def crt_partitions(size: int, ms: Sequence[int]) -> list[Partition]:
    """Chinese-remainder partitions (paper §3.1 ex. 4): pairwise-coprime moduli."""
    ms = list(ms)
    for i in range(len(ms)):
        for j in range(i + 1, len(ms)):
            if math.gcd(ms[i], ms[j]) != 1:
                raise ValueError(f"moduli {ms[i]} and {ms[j]} are not coprime")
    if reduce(lambda a, b: a * b, ms, 1) < size:
        raise ValueError(f"prod({ms}) < size={size}: CRT map not injective on S")
    return [RemainderPartition(size=size, num_buckets=m, m=m) for m in ms]


def codes_for(partitions: Sequence[Partition], idx) -> torch.Tensor:
    """Stack of bucket codes, shape ``idx.shape + (k,)``."""
    return torch.stack([p.bucket(idx) for p in partitions], dim=-1)


def is_complementary(partitions: Sequence[Partition], size: int | None = None) -> bool:
    """Brute-force Definition 1 check: code tuples injective on {0..size-1}.

    Intended for tests and config validation on modest ``size``.
    """
    size = size if size is not None else partitions[0].size
    idx = torch.arange(size)
    codes = codes_for(partitions, idx).numpy()
    return len(np.unique(codes, axis=0)) == size


def min_collision_free_m(size: int) -> int:
    """The m minimising total QR rows m + ceil(size/m): m* = ceil(sqrt(size))."""
    return max(1, math.isqrt(size - 1) + 1) if size > 1 else 1

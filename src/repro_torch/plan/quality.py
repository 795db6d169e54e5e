"""Analytic quality proxy for embedding-table configurations.

The JAX package's ``plan.quality`` over the port's modules and partitions,
expression for expression: numpy sums in the same order, so both
packages score equal stats to the same bits.

One unified score covers every candidate family the planner enumerates,
built from the *frequency-weighted row-sharing* of each partition:

For a partition ``P_j`` with bucket masses ``M_b = sum_{i in b} p_i``, a
category ``i`` shares its table row with foreign traffic mass

    sigma_j(i) = M_{b_j(i)} - p_i .

The proxy **loss** of a configuration with partitions ``P_1..P_k`` is the
expected product of sharings under the traffic distribution:

    L = sum_i p_i * prod_j sigma_j(i)          quality = 1 - L in [0, 1].

Why this shape:

* **hashing** (single remainder partition, k=1) reduces to the expected
  frequency-weighted *collision mass* ``sum_b M_b^2 - sum_i p_i^2`` — the
  probability that a second frequency-weighted draw lands on the same
  (shared, hence corrupted) row;
* a **full table** has singleton buckets, sigma = 0 everywhere, quality 1;
* a **complementary compositional** family (QR, mixed radix) never fully
  collides — code tuples are injective (``partitions.is_complementary``)
  — so its residual degradation is the chance that *every* component row
  of a category is also serving foreign traffic: the product above.  More
  partitions or bigger tables shrink it multiplicatively, matching the
  paper's observed full > QR > hashing quality ordering at equal bytes.

``partition_diagnostics`` additionally reports per-partition normalized
bucket entropy (how evenly traffic spreads over a table's rows — low
entropy means the table wastes rows on cold buckets) and the
code-uniqueness flag from ``is_complementary``; the bench and the plan
JSON carry both.

**Dim-aware scoring** (``dim_proxy_quality``): embedding *width* is the
planner's second axis (Mixed Dimension Embeddings, Ginart et al. 2019 —
the complement to the paper's row reduction).  Two effects, both concave
in width:

* **capacity** — a feature with traffic perplexity ``exp(H)`` needs
  roughly ``log2(1+exp(H)) / BITS_PER_DIM`` dims to keep its effective
  categories apart; width below that required dim discounts quality by
  ``(dim/d_req)^DIM_BETA`` (skewed features have tiny perplexity, so
  they shed width for free — the mixed-dim literature's core claim);
* **sharing amplification** — a *shared* row that is also narrow has
  less spare capacity to encode both traffics apart, so the sharing
  loss is amplified by ``(full_dim/dim)^DIM_ALPHA``.

At ``dim == full_dim`` both factors are exactly 1 and the score reduces
to ``proxy_quality`` — uniform-width plans are byte-identical to the
pre-dim planner.  The exponents are calibrated against the plan-bench
budget sweep (``fit_width_exponent`` refits ``DIM_BETA`` from measured
(width, quality) pairs when real sweep data is available).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from ..core.compositional import (CompositionalEmbedding, FullEmbedding,
                                  HashEmbedding)
from ..core.partitions import (Partition, RemainderPartition, is_complementary,
                               naive_partition)
from .freq import FeatureStats

__all__ = ["module_partitions", "sharing", "proxy_loss", "proxy_quality",
           "partition_entropy", "partition_diagnostics",
           "complementary_flag", "COMPLEMENTARY_CHECK_MAX",
           "required_dim", "width_factor", "dim_proxy_loss",
           "dim_proxy_quality", "fit_width_exponent", "fit_collision_scale",
           "DIM_ALPHA", "DIM_BETA", "BITS_PER_DIM"]

# is_complementary is a brute-force O(size) scan; above this we trust the
# constructors' by-theorem guarantee (paper appendix) instead of checking.
COMPLEMENTARY_CHECK_MAX = 200_000

# Width-model exponents (module docstring): DIM_ALPHA amplifies the
# sharing loss of narrow rows, DIM_BETA discounts capacity below the
# required dim, BITS_PER_DIM converts traffic perplexity to a required
# width.  Calibrated against the plan_bench budget sweep; refit DIM_BETA
# with ``fit_width_exponent`` when measured (width, quality) data exists.
DIM_ALPHA = 0.5
DIM_BETA = 0.5
BITS_PER_DIM = 1.6


def module_partitions(module) -> tuple[Partition, ...]:
    """The partition family an embedding module realizes — the factory's
    modules are the ground truth, so planner scores and built models can
    never disagree about structure."""
    if isinstance(module, CompositionalEmbedding):
        return tuple(module.partitions)
    if isinstance(module, HashEmbedding):
        return (RemainderPartition(size=module.num_categories,
                                   num_buckets=module.m, m=module.m),)
    if isinstance(module, FullEmbedding):
        return tuple(naive_partition(module.num_categories))
    # path-based etc.: fall back to declared partitions if present
    parts = getattr(module, "partitions", None)
    if parts:
        return tuple(parts)
    raise TypeError(f"no partition view for module {type(module).__name__}")


def _buckets(partition: Partition, ids: np.ndarray) -> np.ndarray:
    return np.asarray(partition.bucket(ids)).astype(np.int64)


def sharing(partition: Partition, stats: FeatureStats) -> np.ndarray:
    """sigma_j(i) per observed id: foreign traffic mass on i's bucket.

    Uses unique+inverse instead of a dense ``num_buckets`` bincount so a
    10M-row full table costs O(support), not O(rows).
    """
    if not len(stats.ids):
        return np.zeros(0, np.float64)
    b = _buckets(partition, stats.ids)
    uniq, inv = np.unique(b, return_inverse=True)
    loads = np.bincount(inv, weights=stats.probs)
    return np.maximum(loads[inv] - stats.probs, 0.0)


def proxy_loss(partitions: Sequence[Partition], stats: FeatureStats) -> float:
    """Expected product-of-sharings (module docstring) — in [0, 1]."""
    if not len(stats.ids):
        return 0.0
    sig = np.ones(len(stats.ids), np.float64)
    for p in partitions:
        sig *= sharing(p, stats)
        if not sig.any():
            return 0.0
    return float(np.clip((stats.probs * sig).sum(), 0.0, 1.0))


def proxy_quality(partitions: Sequence[Partition], stats: FeatureStats) -> float:
    return 1.0 - proxy_loss(partitions, stats)


def required_dim(stats: FeatureStats) -> float:
    """Width a feature needs before capacity stops binding:
    ``log2(1 + exp(H)) / BITS_PER_DIM`` where ``exp(H)`` is the traffic
    perplexity (effective category count).  A near-deterministic feature
    (perplexity ~1) needs ~1 dim; a flat 2k-effective-category feature
    needs the full deployment width."""
    if not len(stats.ids):
        return 1.0
    p = stats.probs[stats.probs > 0]
    perp = math.exp(float(-(p * np.log(p)).sum()))
    return max(1.0, math.log2(1.0 + perp) / BITS_PER_DIM)


def width_factor(dim: int, full_dim: int, stats: FeatureStats,
                 beta: float = DIM_BETA) -> float:
    """Concave capacity discount in [0, 1]: ``(dim/d_req)^beta`` below the
    required dim, exactly 1 at ``dim >= min(full_dim, required_dim)`` —
    so full-width candidates always score as the dim-unaware proxy."""
    d_req = min(float(full_dim), required_dim(stats))
    return min(1.0, float(dim) / d_req) ** beta


def dim_proxy_loss(partitions: Sequence[Partition], stats: FeatureStats,
                   dim: int, full_dim: int,
                   alpha: float = DIM_ALPHA) -> float:
    """Sharing loss amplified by ``(full_dim/dim)^alpha``: a narrow shared
    row has less spare capacity to keep its foreign traffic apart."""
    amp = (float(full_dim) / float(dim)) ** alpha
    return min(1.0, proxy_loss(partitions, stats) * amp)


def dim_proxy_quality(partitions: Sequence[Partition], stats: FeatureStats,
                      dim: int, full_dim: int) -> float:
    """Dim-aware quality (module docstring) — equals ``proxy_quality``
    exactly at ``dim == full_dim``."""
    return width_factor(dim, full_dim, stats) * (
        1.0 - dim_proxy_loss(partitions, stats, dim, full_dim))


def fit_width_exponent(samples: Sequence[tuple[float, float]]) -> float:
    """Least-squares fit of the concave width exponent from measured
    ``(width_ratio, quality_ratio)`` pairs (quality at reduced width over
    quality at full width, both in (0, 1]): the ``beta`` minimizing
    ``sum (log q - beta * log r)^2``.  This is the calibration hook the
    module docstring promises — feed it the serve/plan sweep's measured
    deltas to recalibrate ``DIM_BETA``."""
    num = den = 0.0
    for r, q in samples:
        if not (0.0 < r <= 1.0 and 0.0 < q <= 1.0):
            raise ValueError(f"ratios must be in (0, 1], got {(r, q)}")
        if r == 1.0:
            continue  # no width reduction: carries no exponent signal
        lr, lq = math.log(r), math.log(q)
        num += lr * lq
        den += lr * lr
    if den == 0.0:
        raise ValueError("need at least one sample with width_ratio < 1")
    return num / den


def fit_collision_scale(samples: Sequence[tuple[float, float]]) -> float:
    """Calibrate the analytic collision proxy against measured masses.

    ``samples`` are per-feature ``(predicted, measured)`` collision-mass
    pairs — exactly the columns ``BENCH_obs.json`` pins (``predicted_
    collision_mass`` from plan-time stats, ``measured_collision_mass``
    from served traffic).  Returns the scale ``k`` minimizing
    ``sum (measured - k * predicted)^2`` (through the origin: both
    quantities vanish together on a collision-free table), i.e.
    ``k = sum(p*m) / sum(p^2)``.  ``k == 1`` means the proxy is
    calibrated; the drift detector multiplies its predicted baseline by
    ``k`` so a systematic proxy bias is not mistaken for drift.

    Pairs with ``predicted == 0`` carry no scale signal and are skipped —
    a zero-predicted feature with nonzero measured mass is *drift*, not
    miscalibration, and is the detector's job.  Raises when no pair has
    ``predicted > 0`` (the width-axis twin ``fit_width_exponent`` follows
    the same no-signal contract).
    """
    num = den = 0.0
    for p, m in samples:
        if p < 0.0 or m < 0.0:
            raise ValueError(f"collision masses must be >= 0, got {(p, m)}")
        if p == 0.0:
            continue
        num += p * m
        den += p * p
    if den == 0.0:
        raise ValueError("need at least one sample with predicted mass > 0")
    return num / den


def partition_entropy(partition: Partition, stats: FeatureStats) -> float:
    """Normalized frequency-weighted bucket entropy H(M)/log(num_buckets):
    1.0 = traffic spread evenly over the rows, 0.0 = one bucket soaks up
    everything (rows mostly wasted)."""
    if partition.num_buckets <= 1 or not len(stats.ids):
        return 1.0
    b = _buckets(partition, stats.ids)
    uniq, inv = np.unique(b, return_inverse=True)
    loads = np.bincount(inv, weights=stats.probs)
    loads = loads[loads > 0]
    h = float(-(loads * np.log(loads)).sum())
    return min(1.0, h / math.log(partition.num_buckets))


def complementary_flag(partitions: Sequence[Partition],
                       size: int) -> bool | None:
    """Code-uniqueness flag without needless brute force: a lone partition
    decides by pigeonhole (injective iff it has a bucket per category —
    our single-partition modules are identity/mod maps), otherwise the
    O(size) ``is_complementary`` scan runs up to the cap; above it the
    constructors' by-theorem guarantee stands (``None``)."""
    if len(partitions) == 1:
        return partitions[0].num_buckets >= size
    if size <= COMPLEMENTARY_CHECK_MAX:
        return bool(is_complementary(partitions, size))
    return None


def partition_diagnostics(partitions: Sequence[Partition],
                          stats: FeatureStats) -> dict:
    """Per-family diagnostics carried into the plan JSON: entropies, the
    code-uniqueness (complementarity) flag, and the scalar proxy."""
    return {
        "entropies": [round(partition_entropy(p, stats), 6)
                      for p in partitions],
        "complementary": complementary_flag(partitions, stats.size),
        "quality": proxy_quality(partitions, stats),
    }

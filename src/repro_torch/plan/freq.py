"""Per-feature category-frequency statistics — the planner's input signal.

Numpy only, as the JAX package's ``plan.freq``: the same arithmetic in
the same order, so both packages draw equal stats from equal batches.

The paper's compression choices only pay off because category traffic is
heavily skewed (Zipfian Criteo features): a table whose traffic
concentrates on a few categories tolerates aggressive hashing, while a
flat high-cardinality feature needs its bytes.  ``FeatureStats`` captures
that skew as an *empirical* distribution over the observed support:

* ``ids``   — unique category ids seen in the stream (sorted int64);
* ``probs`` — their empirical probabilities (sums to 1 over the support).

Unobserved categories carry zero empirical mass, so the frequency-weighted
quality proxy (``plan.quality``) is exact for the measured traffic and
simply ignores never-seen rows — the same rows a serving cache never
touches.

Constructors cover the two sourcing modes the planner supports:

* ``stats_from_batches`` / ``stats_from_criteo`` — streamed from real
  batches (the port's synthetic Criteo generator, drawn on the CPU so a
  plan never depends on the device that serves it);
* ``power_law_stats`` — closed-form Zipf(alpha) support for tests and
  quick synthesis, no data pass needed.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

__all__ = ["FeatureStats", "stats_from_batches", "stats_from_criteo",
           "power_law_stats", "merge_stats", "StreamingStats"]


@dataclasses.dataclass(frozen=True)
class FeatureStats:
    """Empirical category distribution of one categorical feature."""

    size: int            # cardinality |S| of the feature
    ids: np.ndarray      # (u,) unique observed category ids, sorted
    probs: np.ndarray    # (u,) empirical probabilities, sum == 1

    def __post_init__(self):
        if len(self.ids) != len(self.probs):
            raise ValueError("ids and probs must be parallel arrays")
        if len(self.ids) and int(self.ids.max()) >= self.size:
            raise ValueError(f"observed id {int(self.ids.max())} >= size {self.size}")

    @property
    def support(self) -> int:
        return len(self.ids)

    @property
    def top_mass(self) -> float:
        """Traffic share of the single hottest category (skew headline)."""
        return float(self.probs.max()) if len(self.probs) else 0.0

    def as_dict(self) -> dict:
        return {"size": self.size, "support": self.support,
                "top_mass": self.top_mass}


def _stats_from_counts(size: int, counts: dict[int, int]) -> FeatureStats:
    ids = np.asarray(sorted(counts), np.int64)
    c = np.asarray([counts[i] for i in ids], np.float64)
    total = c.sum()
    probs = c / total if total else c
    return FeatureStats(size=size, ids=ids, probs=probs)


def stats_from_batches(batches: Iterable, table_sizes: Sequence[int],
                       key: str = "sparse") -> list[FeatureStats]:
    """Accumulate per-feature histograms from a stream of training batches.

    ``batches`` yields dicts with an int id array under ``key`` of shape
    ``(B, F)`` one-hot or ``(B, F, L)`` multi-hot (negative ids are treated
    as padding and skipped); arrays may be numpy arrays or CPU tensors.
    One pass, O(unique ids) memory per feature.
    """
    sizes = list(table_sizes)
    counts: list[dict[int, int]] = [{} for _ in sizes]
    for batch in batches:
        arr = np.asarray(batch[key] if isinstance(batch, dict) else batch)
        if arr.ndim == 2:
            arr = arr[..., None]
        if arr.shape[1] != len(sizes):
            raise ValueError(f"batch has {arr.shape[1]} features, "
                             f"expected {len(sizes)}")
        for f in range(len(sizes)):
            ids, n = np.unique(arr[:, f, :].reshape(-1), return_counts=True)
            keep = ids >= 0
            for i, c in zip(ids[keep], n[keep]):
                counts[f][int(i)] = counts[f].get(int(i), 0) + int(c)
    return [_stats_from_counts(s, c) for s, c in zip(sizes, counts)]


def stats_from_criteo(spec, num_batches: int = 32, batch_size: int = 512,
                      seed: int = 0) -> list[FeatureStats]:
    """Stream the port's synthetic Criteo generator (``data.criteo.batch_at``)
    — the same distribution training consumes, so the plan optimizes the
    traffic the model will actually see.  The batches are drawn on the CPU
    whatever device serves: a CUDA generator draws another stream, and the
    plan must not depend on the card."""
    from ..data.criteo import batch_at
    return stats_from_batches(
        (batch_at(seed, step, batch_size, spec, device="cpu")
         for step in range(num_batches)),
        spec.table_sizes)


def merge_stats(a: FeatureStats, b: FeatureStats,
                weight_a: float = 1.0, weight_b: float = 1.0) -> FeatureStats:
    """Weighted union-support merge of two empirical distributions.

    The result's probability for id ``i`` is
    ``(weight_a * p_a(i) + weight_b * p_b(i)) / (weight_a + weight_b)``
    (treating absent ids as zero mass), so merging a window of ``n_a``
    lookups with one of ``n_b`` lookups under ``weight=lookups`` is exactly
    the pooled empirical distribution.  Exponential decay is the same
    operation with a down-weighted left side (``StreamingStats``).
    """
    if a.size != b.size:
        raise ValueError(f"size mismatch: {a.size} vs {b.size}")
    if weight_a < 0 or weight_b < 0:
        raise ValueError("weights must be >= 0")
    wa = weight_a if len(a.ids) else 0.0
    wb = weight_b if len(b.ids) else 0.0
    total = wa + wb
    if total == 0:
        return FeatureStats(size=a.size, ids=np.empty(0, np.int64),
                            probs=np.empty(0, np.float64))
    ids = np.union1d(a.ids, b.ids)
    probs = np.zeros(len(ids), np.float64)
    if wa:
        probs[np.searchsorted(ids, a.ids)] += wa * np.asarray(a.probs)
    if wb:
        probs[np.searchsorted(ids, b.ids)] += wb * np.asarray(b.probs)
    return FeatureStats(size=a.size, ids=ids, probs=probs / total)


class StreamingStats:
    """Per-feature decayed frequency accumulator over live batches.

    The online re-planning loop needs two views of traffic: a *short*
    window (the drift detector's, reset every check) and a *long* decayed
    history to re-solve the plan from — a re-solve on one noisy window
    would thrash.  This class is the long view: each ``update`` first
    multiplies every accumulated weight by ``decay`` and then adds the
    new observation counts, so a category's weight is a geometric sum
    over its appearance history and dead categories fade out instead of
    pinning bytes forever.

    ``decay=1.0`` accumulates exactly like ``stats_from_batches`` (tested
    equal).  ``max_support`` (optional) bounds per-feature memory by
    dropping the lowest-weight ids after each update — drops are counted
    in ``pruned`` per feature, never silent.
    """

    def __init__(self, table_sizes: Sequence[int], decay: float = 1.0,
                 max_support: int | None = None):
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay={decay} must be in (0, 1]")
        self.table_sizes = tuple(int(s) for s in table_sizes)
        self.decay = float(decay)
        self.max_support = max_support
        self._ids = [np.empty(0, np.int64) for _ in self.table_sizes]
        self._weights = [np.empty(0, np.float64) for _ in self.table_sizes]
        self.pruned = [0] * len(self.table_sizes)
        self.updates = 0

    def _merge_feature(self, f: int, ids: np.ndarray, w: np.ndarray) -> None:
        cat_ids = np.concatenate([self._ids[f], ids])
        cat_w = np.concatenate([self._weights[f] * self.decay, w])
        uniq, inv = np.unique(cat_ids, return_inverse=True)
        weights = np.bincount(inv, weights=cat_w)
        if self.max_support is not None and len(uniq) > self.max_support:
            keep = np.sort(np.argsort(weights)[-self.max_support:])
            self.pruned[f] += len(uniq) - self.max_support
            uniq, weights = uniq[keep], weights[keep]
        self._ids[f], self._weights[f] = uniq, weights

    def update(self, batch, key: str = "sparse") -> None:
        """Fold one training batch (``(B, F)`` or ``(B, F, L)`` id array,
        negatives = padding) into the decayed history.  One decay step per
        call, applied to every feature."""
        arr = np.asarray(batch[key] if isinstance(batch, dict) else batch)
        if arr.ndim == 2:
            arr = arr[..., None]
        if arr.shape[1] != len(self.table_sizes):
            raise ValueError(f"batch has {arr.shape[1]} features, "
                             f"expected {len(self.table_sizes)}")
        self.updates += 1
        for f in range(len(self.table_sizes)):
            ids, counts = np.unique(arr[:, f, :].reshape(-1),
                                    return_counts=True)
            keep = ids >= 0
            self._merge_feature(f, ids[keep].astype(np.int64),
                                counts[keep].astype(np.float64))

    def update_stats(self, window: Sequence[FeatureStats],
                     lookups: Sequence[int]) -> None:
        """Fold one telemetry window (per-feature ``FeatureStats`` + their
        lookup counts, e.g. ``CollisionTelemetry.all_observed_stats()``)
        into the history — the serving-side twin of ``update``."""
        if len(window) != len(self.table_sizes):
            raise ValueError("window has wrong feature count")
        self.updates += 1
        for f, st in enumerate(window):
            w = float(lookups[f]) * np.asarray(st.probs, np.float64)
            self._merge_feature(f, np.asarray(st.ids, np.int64), w)

    def snapshot(self, feature: int) -> FeatureStats:
        w = self._weights[feature]
        total = w.sum()
        probs = w / total if total else w.copy()
        return FeatureStats(size=self.table_sizes[feature],
                            ids=self._ids[feature].copy(), probs=probs)

    def all_stats(self) -> list[FeatureStats]:
        """Per-feature ``FeatureStats`` of the decayed history — feed to
        ``build_plan`` for the drift-triggered re-solve."""
        return [self.snapshot(f) for f in range(len(self.table_sizes))]


def power_law_stats(size: int, alpha: float = 1.2,
                    max_support: int = 100_000) -> FeatureStats:
    """Closed-form Zipf(alpha) stats: ``p_i ∝ (i+1)^-alpha`` over the first
    ``min(size, max_support)`` categories (the tail past ``max_support``
    carries negligible mass for alpha > 1; tests use this for speed)."""
    u = min(size, max_support)
    ids = np.arange(u, dtype=np.int64)
    probs = (ids + 1.0) ** (-alpha)
    probs /= probs.sum()
    return FeatureStats(size=size, ids=ids, probs=probs)

"""Measured collision-mass telemetry — the planner's feedback signal.

The planner (``repro_torch.plan``) chooses per-feature table structures by a
*predicted* collision mass: the frequency-weighted product-of-sharings
proxy (``plan.quality.proxy_loss``) evaluated on training-time frequency
stats.  Serving traffic is the ground truth that prediction is supposed
to describe — SCMA (PAPERS.md) frames memory allocation as driven by
live access statistics, and the Embedding Compression survey's core
warning is that compression choices must be validated against measured,
not modeled, quantities.  This module closes that loop:

``CollisionTelemetry`` accumulates the raw category ids each feature
actually served (the engine records every live ``(idx, mask)`` wave when
obs is on), then evaluates the *same* proxy formula on the observed
empirical distribution.  Predicted and measured are therefore directly
comparable numbers — same estimator, different distribution — so a gap
between them is a *traffic drift* signal, not a formula mismatch:

    predicted = proxy_loss(partitions, train_stats)     # plan time
    measured  = proxy_loss(partitions, observed_stats)  # serve time

``observed_stats`` returns honest ``plan.freq.FeatureStats``, so the
telemetry feeds straight back into the planner: ``build_plan(telemetry.
all_observed_stats(), ...)`` re-plans for the traffic the system is
*actually* serving (``repro_torch.online`` does), and the
measured masses are exactly the calibration data the
``fit_width_exponent``-style hooks in ``plan.quality`` were waiting on.

Accumulation is O(wave) per wave (an append of the live ids) with
periodic ``np.unique`` compaction every ``compact_every`` waves, so a
long-running engine holds O(support) memory per feature, not O(traffic).

Numpy on the host, as the JAX package's: the engine records the host id
and mask arrays it pads each wave into, before they are copied to the
device, so the telemetry never reads anything back from the card, and
both packages give equal stats and masses on equal id streams.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["CollisionTelemetry", "predicted_collision_mass"]


def predicted_collision_mass(module, stats) -> float:
    """The planner's predicted collision mass for one feature's module
    under ``stats`` (``plan.freq.FeatureStats``): ``proxy_loss`` over the
    module's own partition view — the number ``TablePlan.quality`` was
    derived from, recomputed here so benches can tabulate it next to the
    measured value without reloading a plan."""
    from ..plan.quality import module_partitions, proxy_loss
    return proxy_loss(module_partitions(module), stats)


class CollisionTelemetry:
    """Per-feature served-traffic histograms + measured collision mass.

    ``record(idx, mask)`` takes one padded wave (``(B, F, L)`` raw ids
    and its 0/1 mask) and accumulates every live id.  Ids are the *raw*
    category ids (pre any hashing) — the partition view is what folds
    them, exactly as it does for the planner's training stats.
    """

    _SHIFT = 44  # packed key: (feature << 44) | raw id — recsys's layout

    def __init__(self, table_sizes: Sequence[int], compact_every: int = 64):
        self.table_sizes = tuple(int(s) for s in table_sizes)
        self.compact_every = compact_every
        self._offsets = (np.arange(len(self.table_sizes), dtype=np.int64)
                         << self._SHIFT)
        self._pending: list[np.ndarray] = []   # 1-D packed live ids
        self._ids = np.empty(0, np.int64)      # packed, sorted unique
        self._counts = np.empty(0, np.int64)
        # support-novelty counter: fraction of served lookups whose raw id
        # was NOT in the baseline support the plan was solved from — ids
        # the planner never scored, the leading edge of traffic drift
        self._baseline: Optional[np.ndarray] = None   # packed, sorted
        self._lookups = np.zeros(len(self.table_sizes), np.int64)
        self._unseen = np.zeros(len(self.table_sizes), np.int64)
        self.waves = 0
        self.requests = 0

    # ------------------------------------------------------------ recording

    def record(self, idx: np.ndarray, mask: np.ndarray,
               live_rows: Optional[int] = None) -> None:
        """Accumulate one wave.  ``live_rows`` (the unpadded batch) trims
        padded batch rows; padded bag slots are excluded by the mask.
        Hot-path cost is two vectorized ops (pack + mask-select); the
        unique/merge work is deferred to periodic compaction."""
        if live_rows is not None:
            idx, mask = idx[:live_rows], mask[:live_rows]
        packed = (np.asarray(idx).astype(np.int64)
                  + self._offsets[None, :, None])[np.asarray(mask) > 0]
        self._pending.append(packed)
        feat = packed >> self._SHIFT
        self._lookups += np.bincount(feat, minlength=len(self.table_sizes))
        if self._baseline is not None and packed.size:
            pos = np.searchsorted(self._baseline, packed)
            pos_c = np.minimum(pos, max(self._baseline.size - 1, 0))
            seen = ((pos < self._baseline.size)
                    & (self._baseline.size > 0)
                    & (self._baseline[pos_c] == packed))
            self._unseen += np.bincount(feat[~seen],
                                        minlength=len(self.table_sizes))
        self.waves += 1
        self.requests += int(idx.shape[0])
        if len(self._pending) >= self.compact_every:
            self._compact()

    def reset(self) -> None:
        """Drop all accumulated traffic.  The online drift detector judges
        *windows*: the controller reads a window's measured masses, calls
        ``reset()``, and the next check sees only fresh traffic — while the
        long-horizon view lives in ``plan.freq.StreamingStats``, which the
        controller feeds from each window before resetting."""
        self._pending = []
        self._ids = np.empty(0, np.int64)
        self._counts = np.empty(0, np.int64)
        # the baseline is a plan-time reference, not traffic — it survives
        # the window reset; only the per-window counters restart
        self._lookups = np.zeros(len(self.table_sizes), np.int64)
        self._unseen = np.zeros(len(self.table_sizes), np.int64)
        self.waves = 0
        self.requests = 0

    def set_baseline(self, per_feature) -> None:
        """Install the baseline support for the novelty counter.

        ``per_feature`` is one entry per categorical feature: either a
        ``plan.freq.FeatureStats`` (its ``ids`` field is used — pass the
        exact stats the live plan was solved from) or a bare id array.
        Subsequent waves count, per feature, lookups whose id is outside
        this support; ``report()`` surfaces the rate."""
        if len(per_feature) != len(self.table_sizes):
            raise ValueError(f"baseline has {len(per_feature)} features, "
                             f"telemetry tracks {len(self.table_sizes)}")
        packed = [np.asarray(getattr(f, "ids", f), np.int64)
                  + (np.int64(i) << self._SHIFT)
                  for i, f in enumerate(per_feature)]
        self._baseline = np.unique(np.concatenate(packed)) if packed \
            else np.empty(0, np.int64)
        self._lookups = np.zeros(len(self.table_sizes), np.int64)
        self._unseen = np.zeros(len(self.table_sizes), np.int64)

    def unseen_id_rate(self, feature: int) -> Optional[float]:
        """Fraction of this feature's served lookups outside the baseline
        support (``None`` until ``set_baseline`` is called)."""
        if self._baseline is None:
            return None
        n = int(self._lookups[feature])
        return float(self._unseen[feature] / n) if n else 0.0

    def _compact(self) -> None:
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        fresh = np.concatenate(pending)
        if not fresh.size:
            return
        ids, counts = np.unique(fresh, return_counts=True)
        merged = np.concatenate([self._ids, ids])
        weights = np.concatenate([self._counts, counts])
        uniq, inv = np.unique(merged, return_inverse=True)
        self._ids = uniq
        self._counts = np.bincount(inv, weights=weights).astype(np.int64)

    def _feature_slice(self, feature: int):
        lo = np.searchsorted(self._ids, feature << self._SHIFT)
        hi = np.searchsorted(self._ids, (feature + 1) << self._SHIFT)
        return (self._ids[lo:hi] - (feature << self._SHIFT),
                self._counts[lo:hi])

    # ------------------------------------------------------------ reading

    def observed_lookups(self, feature: int) -> int:
        self._compact()
        return int(self._feature_slice(feature)[1].sum())

    def observed_support(self, feature: int) -> int:
        self._compact()
        return int(self._feature_slice(feature)[0].size)

    def observed_stats(self, feature: int):
        """``plan.freq.FeatureStats`` of the served traffic for one
        feature — the planner-feedback hook (feed to ``build_plan`` to
        re-plan for live traffic)."""
        from ..plan.freq import FeatureStats
        self._compact()
        ids, counts = self._feature_slice(feature)
        total = counts.sum()
        probs = counts / total if total else counts.astype(np.float64)
        return FeatureStats(size=self.table_sizes[feature], ids=ids,
                            probs=probs)

    def all_observed_stats(self) -> list:
        return [self.observed_stats(i) for i in range(len(self.table_sizes))]

    def measured_collision_mass(self, module, feature: int) -> float:
        """``proxy_loss`` of ``module``'s partitions under the traffic
        this feature actually served — the measured twin of the
        planner's predicted value."""
        from ..plan.quality import module_partitions, proxy_loss
        return proxy_loss(module_partitions(module),
                          self.observed_stats(feature))

    def report(self, modules, predicted_stats=None, plan=None) -> list[dict]:
        """Per-feature predicted-vs-observed table (the ``BENCH_obs``
        payload).  ``modules`` are the engine's embedding modules;
        ``predicted_stats`` (optional, per-feature ``FeatureStats`` the
        plan was solved from) fills the predicted column; ``plan``
        (optional ``MemoryPlan``) annotates the planned kind/quality."""
        out = []
        for i, mod in enumerate(modules):
            row = {
                "feature": i,
                "size": self.table_sizes[i],
                "observed_lookups": self.observed_lookups(i),
                "observed_support": self.observed_support(i),
                "unseen_id_rate": self.unseen_id_rate(i),
                "measured_collision_mass":
                    self.measured_collision_mass(mod, i),
            }
            if predicted_stats is not None:
                row["predicted_collision_mass"] = predicted_collision_mass(
                    mod, predicted_stats[i])
            if plan is not None:
                t = plan.tables[i]
                row["kind"] = t.kind
                row["planned_quality"] = t.quality
                row["dim"] = t.dim or plan.emb_dim
            out.append(row)
        return out

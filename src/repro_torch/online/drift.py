"""Drift detection on the measured-vs-predicted collision gap.

``obs.CollisionTelemetry`` evaluates the planner's own collision-mass
proxy on the ids serving actually saw; the plan was solved to make the
*predicted* value small.  When traffic drifts — the popularity head moves,
the histogram flattens — the measured mass rises above the prediction on
the hashed/QR tables, because more (or different) effective categories now
share rows.  That one-sided gap is the re-plan trigger.

The detector judges telemetry *windows* (the controller resets the
telemetry between checks) and is deliberately sluggish:

* a feature is **over** when ``measured > scale * predicted * (1 + rel)
  + abs`` — ``scale`` comes from ``plan.quality.fit_collision_scale`` so
  a systematic proxy bias is calibrated away, ``rel``/``abs`` absorb
  sampling noise, and features with fewer than ``min_lookups`` window
  lookups abstain entirely (an empty window proves nothing);
* **hysteresis**: only ``hysteresis`` *consecutive* over-windows fire —
  a single noisy window never triggers a re-solve;
* **cooldown**: after a fire (or a ``rebase`` to a fresh plan) the next
  ``cooldown`` checks cannot fire, so the loop cannot thrash while the
  newly-migrated tables settle.

Pure Python, as the JAX package's: both packages give the same decision
sequence on the same telemetry windows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

__all__ = ["DriftThresholds", "DriftDecision", "DriftDetector"]


@dataclasses.dataclass(frozen=True)
class DriftThresholds:
    """Knobs of the one-sided gap test (module docstring)."""
    rel_gap: float = 0.5        # fire at measured > scale*pred*(1+rel)+abs
    abs_gap: float = 1e-3
    min_lookups: int = 256      # windows thinner than this abstain
    hysteresis: int = 2         # consecutive over-windows needed to fire
    cooldown: int = 3           # post-fire quiet checks
    collision_scale: float = 1.0  # fit_collision_scale calibration


@dataclasses.dataclass(frozen=True)
class DriftDecision:
    """One window's verdict: which features exceeded the gap, the
    per-feature (predicted, measured) pairs behind it, and the detector's
    streak/cooldown state after this check."""
    fired: bool
    over: tuple[int, ...]
    gaps: dict
    streak: int
    cooldown: int


class DriftDetector:
    """Windowed measured-vs-predicted gap test with hysteresis+cooldown."""

    def __init__(self, modules: Sequence, predicted: Sequence[float],
                 thresholds: Optional[DriftThresholds] = None):
        if len(modules) != len(predicted):
            raise ValueError("one predicted mass per module")
        self.modules = list(modules)
        self.predicted = [float(p) for p in predicted]
        self.thresholds = thresholds or DriftThresholds()
        self._streak = 0
        self._cooldown = 0
        self.checks = 0
        self.fires = 0

    @classmethod
    def from_stats(cls, modules: Sequence, stats: Sequence,
                   thresholds: Optional[DriftThresholds] = None
                   ) -> "DriftDetector":
        """Baseline the prediction from the stats the current plan was
        solved on (or, bootstrapping, from the first served window)."""
        from ..obs.collision import predicted_collision_mass
        return cls(modules,
                   [predicted_collision_mass(m, s)
                    for m, s in zip(modules, stats)], thresholds)

    def check(self, telemetry) -> DriftDecision:
        """Judge one telemetry window.  Does not reset the telemetry —
        that is the caller's windowing decision (the controller resets
        after folding the window into its streaming history)."""
        th = self.thresholds
        self.checks += 1
        over, gaps = [], {}
        for i, mod in enumerate(self.modules):
            if telemetry.observed_lookups(i) < th.min_lookups:
                continue
            measured = telemetry.measured_collision_mass(mod, i)
            predicted = th.collision_scale * self.predicted[i]
            gaps[i] = (predicted, measured)
            if measured > predicted * (1.0 + th.rel_gap) + th.abs_gap:
                over.append(i)
        self._streak = self._streak + 1 if over else 0
        fired = bool(over) and self._streak >= th.hysteresis \
            and self._cooldown == 0
        if fired:
            self.fires += 1
            self._streak = 0
            self._cooldown = th.cooldown
        elif self._cooldown:
            self._cooldown -= 1
        return DriftDecision(fired=fired, over=tuple(over), gaps=gaps,
                             streak=self._streak, cooldown=self._cooldown)

    def rebase(self, modules: Sequence, predicted: Sequence[float]) -> None:
        """Point the detector at a freshly-installed plan: new structures,
        new predicted baseline, streak cleared, and a full cooldown so the
        first post-swap windows (mid-migration traffic, cold moments)
        cannot immediately re-fire."""
        if len(modules) != len(predicted):
            raise ValueError("one predicted mass per module")
        self.modules = list(modules)
        self.predicted = [float(p) for p in predicted]
        self._streak = 0
        self._cooldown = self.thresholds.cooldown

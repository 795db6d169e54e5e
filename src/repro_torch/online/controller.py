"""The closed loop: watch → detect → re-solve → migrate → hot-swap.

``ReplanController`` wraps a running ``RecsysEngine`` (single device, obs
with collision telemetry attached) and turns the planner from a one-shot
tool into a control system, as the JAX package's controller does.  Each
``check()``:

1. reads the telemetry's current *window* (per-feature observed stats and
   the measured collision masses), folds it into a long-horizon decayed
   ``StreamingStats``, and resets the telemetry so the next window is
   independent;
2. asks the ``DriftDetector`` whether the measured-vs-predicted gap has
   persisted past hysteresis (the first window baselines the detector
   instead of judging, when no plan-time stats were given);
3. on fire: re-solves ``build_plan`` on the *decayed streaming* stats
   (not the single noisy window), draws the new plan's fresh parameters
   on the CPU from ``torch.Generator().manual_seed(seed)`` and moves them
   to the engine's device, warm-starts the new tables from the served
   params there (``online.migrate``), re-quantizes to the engine's serving
   mode, and ``engine.swap_plan``s — then rebases the detector on the new
   structures' predicted masses under the same stats the plan was solved
   from, with a full cooldown.

Everything is synchronous and in-process: the engine's drain-then-install
swap keeps it off the wave path.  ``launch.serve --replan-interval`` runs
this against live traffic.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from ..obs.collision import predicted_collision_mass
from ..plan.freq import StreamingStats
from .drift import DriftDecision, DriftDetector, DriftThresholds

__all__ = ["ReplanController"]


class ReplanController:
    def __init__(self, engine, *, budget_bytes: int,
                 thresholds: Optional[DriftThresholds] = None,
                 decay: float = 0.8,
                 dims: Optional[Sequence[int]] = None,
                 quantize: Optional[str] = None,
                 plan_stats: Optional[Sequence] = None,
                 seed: int = 0):
        """``budget_bytes`` bounds every re-solve (train_f32 domain, the
        same knob ``build_plan`` takes).  ``plan_stats`` are the stats the
        *current* plan was solved from — given, the detector starts armed;
        omitted, the first served window becomes the baseline (boot
        traffic is presumed normal).  ``quantize`` re-applies the engine's
        serving mode ("int8"/"bf16") to migrated params; ``decay`` is the
        per-window factor of the streaming history; ``dims`` forwards a
        width ladder to ``build_plan``; ``seed`` seeds the new plan's
        fresh parameters."""
        obs = engine._obs
        if obs is None or obs.collisions is None:
            raise ValueError("ReplanController needs an engine with obs "
                             "collision telemetry attached "
                             "(Obs(collisions=True))")
        self.engine = engine
        self.budget_bytes = int(budget_bytes)
        self.thresholds = thresholds or DriftThresholds()
        self.dims = tuple(dims) if dims else None
        self.quantize = quantize
        self.seed = seed
        self.stream = StreamingStats(engine.cfg.table_sizes, decay=decay)
        self.detector: Optional[DriftDetector] = None
        if plan_stats is not None:
            self.detector = DriftDetector.from_stats(
                engine.modules, plan_stats, self.thresholds)
        self.checks = 0
        self.replans: list[dict] = []
        self.last_decision: Optional[DriftDecision] = None

    # ------------------------------------------------------------ the loop

    def check(self) -> Optional[DriftDecision]:
        """One control-loop tick.  Returns the window's ``DriftDecision``
        (None when the window was empty or only baselined the detector);
        a fired decision has already re-planned and swapped by the time
        this returns — the report is appended to ``self.replans``."""
        tele = self.engine._obs.collisions
        if tele.waves == 0:
            return None
        self.checks += 1
        window = tele.all_observed_stats()
        lookups = [tele.observed_lookups(i) for i in range(len(window))]
        self.stream.update_stats(window, lookups)
        if self.detector is None:
            # bootstrap: the first window defines "normal"
            self.detector = DriftDetector.from_stats(
                self.engine.modules, window, self.thresholds)
            tele.reset()
            return None
        decision = self.detector.check(tele)
        tele.reset()
        self.last_decision = decision
        if decision.fired:
            self.replans.append(self.replan(trigger=decision))
        return decision

    def replan(self, trigger: Optional[DriftDecision] = None) -> dict:
        """Re-solve on the streaming stats, migrate, swap, rebase.

        Public so a caller can force a re-plan (an operator knob) without
        waiting for the detector."""
        import torch

        from ..configs import get_arch
        from ..plan.planner import build_plan
        from ..serve.recsys import _to_device
        from .migrate import migrate_params

        engine = self.engine
        stats = self.stream.all_stats()
        old_cfg = engine.cfg
        plan = build_plan(stats, old_cfg.emb_dim, self.budget_bytes,
                          arch=f"{old_cfg.name}-online", dims=self.dims)
        new_cfg = dataclasses.replace(old_cfg, embedding=plan)
        # drawn on the CPU, as every parameter of the port is, then moved:
        # a CUDA generator would draw another stream
        api = get_arch(old_cfg.name).api(new_cfg, "cpu")
        fresh = _to_device(api.init(torch.Generator().manual_seed(self.seed)), engine.device)
        migrated, mreport = migrate_params(old_cfg, engine.params, new_cfg, fresh)
        del fresh
        plan.notes["migration"] = mreport
        if self.quantize:
            from ..serve.quantize import quantize_params
            migrated = quantize_params(migrated, mode=self.quantize)
        swap = engine.swap_plan(new_cfg, migrated)
        self.detector.rebase(
            engine.modules,
            [predicted_collision_mass(m, s) for m, s in zip(engine.modules, stats)])
        return {
            "trigger": None if trigger is None else {
                "over": list(trigger.over),
                "gaps": {str(k): list(v) for k, v in trigger.gaps.items()}},
            "plan": {"total_bytes": plan.total_bytes,
                     "budget_bytes": plan.budget_bytes,
                     "quality": plan.quality,
                     "kinds": [t.kind for t in plan.tables]},
            "migration": mreport["counts"],
            "swap": swap,
        }

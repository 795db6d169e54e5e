"""Online re-planning: drift detection, live table migration, hot-swap.

The paper plans its compositional tables once, offline.  This package
keeps a *running* engine matched to drifting traffic, as the JAX
package's ``online`` does:

* ``drift``      — ``DriftDetector``: measured-vs-predicted collision-mass
  gap per feature, with hysteresis + cooldown (noise never re-solves);
* ``migrate``    — warm-start a new plan's tables from the old structure
  by the partitions' own index maps; optimizer moments carried per-leaf;
* ``controller`` — ``ReplanController``: telemetry window → decayed
  ``StreamingStats`` → detector → ``build_plan`` on observed traffic →
  ``migrate_params`` → ``RecsysEngine.swap_plan``.

``repro_torch.benchmarks.drift_bench`` proves the loop end to end.
"""

from .controller import ReplanController
from .drift import DriftDecision, DriftDetector, DriftThresholds
from .migrate import (migrate_feature, migrate_opt_state, migrate_params,
                      representative_ids)

__all__ = ["DriftDecision", "DriftDetector", "DriftThresholds",
           "ReplanController", "migrate_feature", "migrate_opt_state",
           "migrate_params", "representative_ids"]

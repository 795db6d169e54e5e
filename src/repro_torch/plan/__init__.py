"""repro_torch.plan — frequency-aware memory-budget planner for embedding tables.

The port of the JAX package's ``plan``: given per-feature cardinalities,
empirical category-frequency histograms, and a global byte budget, choose
a per-feature configuration (full / hashed / QR / generalized-QR, at one
width or over a width ladder, with train-f32 or serve-int8 byte
accounting) that maximizes a frequency-weighted analytic quality proxy —
and emit it as a serializable, executable ``MemoryPlan``.  On equal stats
its plans equal the reference's, field for field, and the JSON schema is
shared.

Pipeline::

    freq.stats_from_criteo / power_law_stats      # traffic histograms
      -> candidates.enumerate_candidates          # spec ladder per feature
      -> solver.solve_budget                      # Lagrangian-greedy knapsack
      -> MemoryPlan (artifacts/plans/*.json)      # consumed by train/serve

Consumers: ``core.factory.make_embedding`` builds directly from a plan
(``feature=`` selects the table), ``configs.dlrm_criteo.config(plan=...)``
and ``configs.dcn_criteo.config(plan=...)`` take a plan or its path,
``launch.serve`` takes ``--plan`` / ``--plan-budget-mb`` / ``--plan-dims``,
and ``benchmarks/plan_bench.py`` sweeps budgets against the
uniform-hashing control.
"""

from .candidates import (Candidate, candidate_specs, dim_ladder,
                         enumerate_candidates)
from .freq import (FeatureStats, StreamingStats, merge_stats, power_law_stats,
                   stats_from_batches, stats_from_criteo)
from .memory_plan import PLAN_DIR, MemoryPlan, TablePlan, plan_differences, plan_path
from .planner import (build_plan, full_table_bytes, plan_for_config,
                      uniform_hash_plan)
from .quality import (complementary_flag, dim_proxy_loss, dim_proxy_quality,
                      fit_width_exponent, module_partitions,
                      partition_diagnostics, partition_entropy, proxy_loss,
                      proxy_quality, required_dim, sharing, width_factor)
from .solver import InfeasibleBudget, concave_frontier, solve_budget

__all__ = [
    "FeatureStats", "stats_from_batches", "stats_from_criteo",
    "power_law_stats", "merge_stats", "StreamingStats",
    "Candidate", "candidate_specs", "enumerate_candidates", "dim_ladder",
    "proxy_loss", "proxy_quality", "sharing", "partition_entropy",
    "partition_diagnostics", "module_partitions", "complementary_flag",
    "dim_proxy_loss", "dim_proxy_quality", "width_factor", "required_dim",
    "fit_width_exponent",
    "concave_frontier", "solve_budget", "InfeasibleBudget",
    "TablePlan", "MemoryPlan", "PLAN_DIR", "plan_path", "plan_differences",
    "build_plan", "uniform_hash_plan", "plan_for_config", "full_table_bytes",
]

"""Top-level planning entry points: stats → candidates → solver → MemoryPlan.

``build_plan`` is the pure core (explicit stats in, plan out);
``plan_for_config`` is the convenience wrapper training/serving/benches
call — it streams frequency stats from the port's synthetic Criteo
generator, drawn on the CPU, at the config's table sizes and solves for a
byte budget.

``uniform_hash_plan`` is the control arm: one global compression factor,
every table hashed by the same ratio — the strongest *non-adaptive*
baseline at a given budget, and the bar ``plan_bench`` requires the
planner to beat at every swept budget.  ``build_plan`` scores its own
copy of that baseline for the plan's ``baseline_quality`` field; pass
``baseline=`` (an already-solved uniform plan for the same stats/budget)
to skip recomputing it.
"""

from __future__ import annotations

from typing import Sequence

from ..core.factory import EmbeddingSpec
from .candidates import (Candidate, bytes_per_row, candidate_for,
                         enumerate_candidates)
from .freq import FeatureStats, stats_from_criteo
from .memory_plan import MemoryPlan, TablePlan
from .quality import (complementary_flag, module_partitions,
                      partition_entropy)
from .solver import InfeasibleBudget, solve_budget

__all__ = ["build_plan", "uniform_hash_plan", "plan_for_config",
           "full_table_bytes"]


def full_table_bytes(table_sizes: Sequence[int], dim: int,
                     domain: str = "train_f32") -> int:
    """The all-full-table cost — budgets are usually fractions of this."""
    return sum(table_sizes) * bytes_per_row(dim, domain)


def _table_plan(cand: Candidate, stats: FeatureStats, dim: int) -> TablePlan:
    # the candidate already carries cost and quality from the factory-built
    # module; only the per-partition diagnostics remain to compute
    from ..core.factory import make_embedding
    width = cand.dim or dim
    parts = module_partitions(make_embedding(cand.num_categories, width,
                                             cand.spec))
    s = cand.spec
    return TablePlan(
        feature=cand.feature, num_categories=cand.num_categories,
        kind=s.kind, num_collisions=s.num_collisions, ms=tuple(s.ms), op=s.op,
        rows=cand.rows, train_bytes=cand.train_bytes,
        serve_bytes_int8=cand.serve_bytes_int8,
        quality=cand.quality,
        entropies=tuple(round(partition_entropy(p, stats), 6) for p in parts),
        complementary=complementary_flag(parts, cand.num_categories),
        dim=width)


def _mean_quality(tables) -> float:
    return sum(t.quality for t in tables) / max(1, len(tables))


def _as_memory_plan(chosen: Sequence[Candidate], stats, dim, budget_bytes,
                    arch, bytes_domain, baseline_quality,
                    notes: dict | None = None) -> MemoryPlan:
    tables = [_table_plan(c, st, dim) for c, st in zip(chosen, stats)]
    total = sum(c.bytes(bytes_domain) for c in chosen)
    return MemoryPlan(
        arch=arch, emb_dim=dim, budget_bytes=int(budget_bytes),
        bytes_domain=bytes_domain, total_bytes=int(total),
        full_bytes=full_table_bytes([s.size for s in stats], dim,
                                    bytes_domain),
        quality=_mean_quality(tables),
        baseline_quality=baseline_quality, tables=tables,
        notes=notes or {})


def build_plan(stats: Sequence[FeatureStats], dim: int, budget_bytes: int, *,
               arch: str = "custom", bytes_domain: str = "train_f32",
               op: str = "mult",
               baseline: MemoryPlan | None = None,
               dims: Sequence[int] | None = None) -> MemoryPlan:
    """Solve the budgeted allocation and emit an executable ``MemoryPlan``.

    ``baseline``: a ``uniform_hash_plan`` already solved for the same
    stats/budget/domain; omitted, one is scored internally (its mean
    quality fills ``baseline_quality``).

    ``dims``: optional width ladder (e.g. ``dim_ladder(dim)`` = {D/4,
    D/2, D}) — the mixed-dimension axis.  Default: uniform width ``dim``
    (byte-identical to the pre-dim planner).  The emitted plan's
    ``notes`` carry the solver's parked-upgrade / hull-drop audit trail.
    """
    ladders = [enumerate_candidates(f, st, dim, op=op,
                                    bytes_domain=bytes_domain,
                                    dims=tuple(dims) if dims else None)
               for f, st in enumerate(stats)]
    notes: dict = {}
    chosen = solve_budget(ladders, budget_bytes,
                          lambda c: c.bytes(bytes_domain), notes=notes)
    total = sum(c.bytes(bytes_domain) for c in chosen)
    assert total <= budget_bytes, (total, budget_bytes)  # solver invariant
    if dims:
        notes["dim_ladder"] = sorted(set(int(d) for d in dims))
    if baseline is None:
        baseline_q = _mean_quality(_uniform_candidates(
            stats, dim, budget_bytes, bytes_domain))
    else:
        baseline_q = baseline.quality
    return _as_memory_plan(chosen, stats, dim, budget_bytes, arch,
                           bytes_domain, baseline_q, notes=notes)


def _uniform_candidates(stats, dim, budget_bytes,
                        bytes_domain) -> list[Candidate]:
    """One global hash ratio ``r`` (rows_i = max(1, floor(r·n_i))), the
    largest that fits the budget (binary search, same byte accounting as
    the planner's candidates)."""
    sizes = [s.size for s in stats]
    per_row = bytes_per_row(dim, bytes_domain)

    def bytes_at(r: float) -> int:
        return sum(max(1, min(n, int(r * n))) * per_row for n in sizes)

    if bytes_at(0.0) > budget_bytes:
        raise InfeasibleBudget(
            f"budget {budget_bytes} B < one row per table "
            f"({bytes_at(0.0)} B) in domain {bytes_domain}")
    lo, hi = 0.0, 1.0
    for _ in range(60):
        mid = (lo + hi) / 2
        if bytes_at(mid) <= budget_bytes:
            lo = mid
        else:
            hi = mid
    out = []
    for f, st in enumerate(stats):
        n = st.size
        m = max(1, min(n, int(lo * n)))
        # the factory's hash path sizes m = ceil(n/c); invert to a c that
        # reproduces at most m rows so the baseline is executable too
        c = max(1, -(-n // m))
        spec = EmbeddingSpec(kind="full" if m >= n else "hash",
                             num_collisions=c)
        out.append(candidate_for(f, st, dim, spec))
    return out


def uniform_hash_plan(stats: Sequence[FeatureStats], dim: int,
                      budget_bytes: int, *, arch: str = "custom",
                      bytes_domain: str = "train_f32") -> MemoryPlan:
    """The non-adaptive control as a full (executable) ``MemoryPlan``."""
    chosen = _uniform_candidates(stats, dim, budget_bytes, bytes_domain)
    return _as_memory_plan(chosen, stats, dim, budget_bytes, arch,
                           bytes_domain,
                           baseline_quality=_mean_quality(chosen))


def plan_for_config(cfg, budget_bytes: int, *, arch: str | None = None,
                    bytes_domain: str = "train_f32", num_batches: int = 32,
                    batch_size: int = 512, zipf: float = 1.5,
                    noise: float = 0.5, seed: int = 0,
                    dims: Sequence[int] | None = None) -> MemoryPlan:
    """Plan for a rec model config (``DLRMConfig`` / ``DCNConfig``):
    streams frequency stats from the port's synthetic Criteo generator on
    the CPU at the config's table sizes (the same zipf the training
    configs use), then solves at ``budget_bytes``.  ``dims`` enables the mixed-dimension
    width ladder (``build_plan`` docstring)."""
    from ..data.criteo import CriteoSpec
    spec = CriteoSpec(table_sizes=tuple(cfg.table_sizes), zipf=zipf,
                      noise=noise)
    stats = stats_from_criteo(spec, num_batches=num_batches,
                              batch_size=batch_size, seed=seed)
    op = getattr(getattr(cfg, "embedding", None), "op", "mult")
    if op not in ("mult", "add", "concat"):
        op = "mult"
    return build_plan(stats, cfg.emb_dim, budget_bytes,
                      arch=arch or getattr(cfg, "name", "custom"),
                      bytes_domain=bytes_domain, op=op, dims=dims)

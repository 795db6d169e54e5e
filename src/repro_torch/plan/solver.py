"""Budgeted allocation: Lagrangian-greedy knapsack over candidate ladders.

The JAX package's ``plan.solver`` line for line, so both packages pick the
same candidates.  The walk parks an upgrade that does not fit and never
revisits it: it is not an exact multiple-choice knapsack, so a wider
candidate ladder (the mixed-dimension one) can end below a narrower one
at the same budget.  The port keeps that behaviour: its plans must equal
the reference's.

The planner's optimization problem is a multiple-choice knapsack — pick
exactly one candidate per feature, maximize total quality subject to a
global byte budget.  Exact MCKP is NP-hard; the classic Lagrangian
relaxation is exact on *concave* per-feature frontiers and runs in
``O(F · L log L)``:

1. per feature, reduce the candidate ladder to its **upper convex hull**
   in (bytes, quality) — dominated and non-concave points can never be
   picked by any Lagrange multiplier;
2. start every feature at its cheapest hull point (the all-minimum
   allocation — feasibility floor);
3. repeatedly apply the hull upgrade with the best marginal
   ``dquality/dbyte`` that still fits the remaining budget.

Because hull slopes decrease along each ladder, the greedy sequence is
exactly the sweep of the Lagrange multiplier from +inf down to 0, so the
result matches the relaxed optimum at every budget it passes through —
and, operationally, a larger budget's solution is a superset of a
smaller one's upgrades, which makes total quality **monotone
non-decreasing in budget** (a planner invariant the tests pin).
"""

from __future__ import annotations

import heapq
from typing import Callable, Sequence

from .candidates import Candidate

__all__ = ["concave_frontier", "solve_budget", "InfeasibleBudget"]


class InfeasibleBudget(ValueError):
    """Budget below the sum of every feature's cheapest candidate."""


def concave_frontier(cands: Sequence[Candidate],
                     cost: Callable[[Candidate], int]) -> list[Candidate]:
    """Upper convex hull of (cost, quality), cost strictly increasing."""
    pts = sorted(cands, key=lambda c: (cost(c), -c.quality))
    # drop points not strictly better than a cheaper one (dominated)
    mono: list[Candidate] = []
    for c in pts:
        if mono and cost(c) == cost(mono[-1]):
            continue
        if mono and c.quality <= mono[-1].quality:
            continue
        mono.append(c)
    # Graham-scan style hull: slopes must strictly decrease
    hull: list[Candidate] = []
    for c in mono:
        while len(hull) >= 2:
            a, b = hull[-2], hull[-1]
            s_ab = (b.quality - a.quality) / (cost(b) - cost(a))
            s_bc = (c.quality - b.quality) / (cost(c) - cost(b))
            if s_bc >= s_ab:  # b is under the a--c chord: never optimal
                hull.pop()
            else:
                break
        hull.append(c)
    return hull


def solve_budget(ladders: Sequence[Sequence[Candidate]], budget: int,
                 cost: Callable[[Candidate], int],
                 notes: dict | None = None) -> list[Candidate]:
    """One candidate per feature, total cost <= budget, greedy-optimal
    quality (module docstring).  Raises ``InfeasibleBudget`` if even the
    all-cheapest allocation overshoots.

    ``notes`` (optional dict, filled in place) records what the solve
    silently left on the table — the ROADMAP "no silent caps" rule:

    * ``parked``        — one entry per feature whose next hull upgrade
      did not fit the remaining budget (feature, the upgrade's label,
      extra bytes it needed, quality it would have added);
    * ``hull_dropped``  — ladder candidates not on any hull (dominated,
      non-concave, or an equal-cost duplicate — never pickable);
    * ``leftover_bytes`` — budget minus achieved bytes.
    """
    fronts = [concave_frontier(l, cost) for l in ladders]
    if any(not f for f in fronts):
        raise ValueError("every feature needs at least one candidate")
    chosen = [0] * len(fronts)
    spent = sum(cost(f[0]) for f in fronts)
    if spent > budget:
        raise InfeasibleBudget(
            f"budget {budget} B < floor allocation {spent} B "
            f"(sum of cheapest candidates)")

    def push(heap, fi):
        ci = chosen[fi]
        if ci + 1 < len(fronts[fi]):
            cur, nxt = fronts[fi][ci], fronts[fi][ci + 1]
            dq = nxt.quality - cur.quality
            db = cost(nxt) - cost(cur)
            heapq.heappush(heap, (-dq / db, fi, ci, db))

    heap: list = []
    for fi in range(len(fronts)):
        push(heap, fi)
    parked: list[dict] = []
    # upgrades that momentarily don't fit are parked; a cheaper upgrade
    # elsewhere can't change their cost, but applying others never frees
    # bytes either — so parked entries stay parked (budget only shrinks).
    while heap:
        neg_slope, fi, ci, db = heapq.heappop(heap)
        if chosen[fi] != ci:  # stale entry (already upgraded past it)
            continue
        if spent + db > budget:
            nxt = fronts[fi][ci + 1]
            parked.append({"feature": nxt.feature, "upgrade": nxt.label,
                           "extra_bytes": int(db),
                           "dquality": nxt.quality - fronts[fi][ci].quality})
            continue  # park: this feature is done at this budget
        chosen[fi] = ci + 1
        spent += db
        push(heap, fi)
    if notes is not None:
        notes["parked"] = sorted(parked, key=lambda p: p["feature"])
        notes["hull_dropped"] = sum(
            len(l) - len(f) for l, f in zip(ladders, fronts))
        notes["leftover_bytes"] = int(budget - spent)
    return [f[c] for f, c in zip(fronts, chosen)]

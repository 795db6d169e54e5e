"""Memory-planner benchmark of the port: budget sweep vs the uniform-hashing
control, uniform-width vs mixed-dimension — the JAX package's
``benchmarks/plan_bench.py`` with its sweep, checks, ``summarize`` and
``rows()`` unchanged, on ``repro_torch.plan``.

For each rec arch (the paper's DLRM + DCN, reduced Criteo configs) the
bench streams per-feature frequency stats from the port's synthetic
Criteo generator (drawn on the CPU: the planner runs on the host, on any
machine, and gives the same plans on the card's machine), then solves the budgeted allocation at
``{0.05, 0.125, 0.25, 0.5}×`` of the all-full-table bytes and compares
the planner against a uniform-hashing baseline *at the same budget and
under the same byte accounting*.  Each cell is solved twice: at the
uniform width D and with the mixed-dimension ladder {D/4, D/2, D}
(``plan.dim_ladder``) — the width axis the dim-aware proxy prices.

Built-in acceptance checks (any failure -> ``/ERROR`` row + exit 1, the
``dist_bench``/``serve_bench`` contract):

* **budget respected** — planned bytes <= budget at every cell, exactly
  (the plan's claimed bytes must also equal ``num_params x 4`` of the
  modules ``make_embedding`` actually builds from it — for the mixed-dim
  plan checked *per table*, so per-feature width drift fails the bench,
  not just a test);
* **beats uniform hashing** — the planner's frequency-weighted quality
  proxy is *strictly* above the uniform-hash control at every budget;
* **mixed-dim beats uniform-dim** — the mixed-dimension plan never
  scores below the same-budget uniform-width plan, and *strictly* beats
  it at the 0.125× budget (the deployment point the serving lanes use);
* **complementary** — every compositional choice (qr / mixed_radix)
  passes ``core.partitions.is_complementary`` (brute force; reduced
  sizes are all below the check cap);
* **monotone** — plan quality never decreases as the budget grows, in
  both the uniform-width and the mixed-dim sweeps.

Parked upgrades (``plan.notes["parked"]`` — hull upgrades that did not
fit the budget) ride in every CSV row and in the JSON so a budget sweep
can't silently under-allocate (the ROADMAP "no silent caps" rule).

The solver is the reference's greedy walk, which parks an upgrade that
does not fit for good: it is not an exact multiple-choice knapsack, so at
a tight budget the mixed-dimension ladder can end below the uniform-width
one and the "mixed-dim beats uniform-dim" check fails, here as in the
reference.  The bench reports that and exits 1; it does not loosen the
check.

Artifacts: ``artifacts/bench_torch/BENCH_plan.json`` (+ each solved plan
under ``artifacts/plans/``), a compact mirror beside it
(``artifacts/bench_torch/BENCH_plan_summary.json``: totals + acceptance
booleans; the repo-root ``BENCH_plan.json`` is the reference's and is
not written), and CSV on stdout (``name,us_per_call,derived``).

Usage::

    python -m repro_torch.benchmarks.plan_bench --stats-batches 24
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ART = "artifacts/bench_torch"
ARCHS = ("dlrm-criteo", "dcn-criteo")
BUDGET_FRACS = (0.05, 0.125, 0.25, 0.5)
# the budget where the mixed-dim plan must *strictly* beat uniform-width
MIXED_STRICT_FRAC = 0.125


def _stats_for(arch: str, num_batches: int, batch_size: int):
    from ..configs import get_arch
    from ..data.criteo import CriteoSpec
    from ..plan import stats_from_criteo

    cfg = get_arch(arch).config(reduced=True)
    spec = CriteoSpec(table_sizes=cfg.table_sizes, zipf=1.5, noise=0.5)
    return cfg, stats_from_criteo(spec, num_batches=num_batches,
                                  batch_size=batch_size)


def _plan_cell(arch: str, cfg, stats, frac: float, save: bool) -> dict:
    from ..core import make_embedding
    from ..plan import (build_plan, dim_ladder, full_table_bytes,
                        plan_path, uniform_hash_plan)

    dim = cfg.emb_dim
    full = full_table_bytes(cfg.table_sizes, dim)
    budget = int(full * frac)
    uniform = uniform_hash_plan(stats, dim, budget, arch=arch)
    t0 = time.monotonic()
    plan = build_plan(stats, dim, budget, arch=arch, baseline=uniform)
    solve_s = time.monotonic() - t0
    t0 = time.monotonic()
    mixed = build_plan(stats, dim, budget, arch=f"{arch}-mixed",
                       baseline=uniform, dims=dim_ladder(dim))
    mixed_solve_s = time.monotonic() - t0
    if save:
        plan.save(plan_path(arch, budget))
        mixed.save(plan_path(f"{arch}-mixed", budget))

    # executable round-trip: the bytes the plan claims are the bytes the
    # factory builds (f32 train domain: 4 B per parameter); for the
    # mixed-dim plan the check is per table so width drift can't cancel
    built_params = sum(
        make_embedding(n, dim, plan, feature=i).num_params
        for i, n in enumerate(cfg.table_sizes))
    mixed_built_ok = all(
        make_embedding(n, dim, mixed, feature=i).num_params * 4
        == mixed.tables[i].train_bytes
        for i, n in enumerate(cfg.table_sizes))
    comp_ok = all(t.complementary is True
                  for p in (plan, mixed) for t in p.tables
                  if t.kind in ("qr", "mixed_radix", "crt"))
    return {
        "arch": arch, "budget_frac": frac, "budget_bytes": budget,
        "full_bytes": full, "plan_bytes": plan.total_bytes,
        "built_bytes": built_params * 4,
        "uniform_bytes": uniform.total_bytes,
        "quality": plan.quality, "uniform_quality": uniform.quality,
        "kinds": plan.summary()["kinds"],
        "parked": len(plan.notes.get("parked", [])),
        "leftover_bytes": plan.notes.get("leftover_bytes", 0),
        "mixed_quality": mixed.quality,
        "mixed_bytes": mixed.total_bytes,
        "mixed_built_bytes_ok": mixed_built_ok,
        "mixed_dims": mixed.summary()["dims"],
        "mixed_kinds": mixed.summary()["kinds"],
        "mixed_parked": len(mixed.notes.get("parked", [])),
        "compositional_complementary": comp_ok,
        "solve_ms": round(solve_s * 1e3, 2),
        "mixed_solve_ms": round(mixed_solve_s * 1e3, 2),
    }


def bench(stats_batches: int, batch_size: int, save_plans: bool) -> dict:
    rows = []
    for arch in ARCHS:
        cfg, stats = _stats_for(arch, stats_batches, batch_size)
        for frac in BUDGET_FRACS:
            rows.append(_plan_cell(arch, cfg, stats, frac, save_plans))
    return {"archs": list(ARCHS), "budget_fracs": list(BUDGET_FRACS),
            "stats_batches": stats_batches, "batch_size": batch_size,
            "rows": rows}


def check(report: dict) -> list[tuple[str, str]]:
    """(name, message) per failed acceptance check; empty = all green."""
    failures = []
    by_arch: dict[str, list] = {}
    for r in report["rows"]:
        cell = f"{r['arch']}/b{r['budget_frac']:g}"
        by_arch.setdefault(r["arch"], []).append(r)
        if r["plan_bytes"] > r["budget_bytes"]:
            failures.append((cell, f"planned bytes {r['plan_bytes']} exceed "
                                   f"budget {r['budget_bytes']}"))
        if r["built_bytes"] != r["plan_bytes"]:
            failures.append((cell, f"cost-model drift: plan claims "
                                   f"{r['plan_bytes']} B, make_embedding "
                                   f"builds {r['built_bytes']} B"))
        if not r["quality"] > r["uniform_quality"]:
            failures.append((cell, f"plan quality {r['quality']:.6f} does not "
                                   f"beat uniform hashing "
                                   f"{r['uniform_quality']:.6f}"))
        if r["mixed_bytes"] > r["budget_bytes"]:
            failures.append((cell, f"mixed-dim planned bytes "
                                   f"{r['mixed_bytes']} exceed budget "
                                   f"{r['budget_bytes']}"))
        if not r["mixed_built_bytes_ok"]:
            failures.append((cell, "mixed-dim cost-model drift: a table's "
                                   "built bytes differ from its planned "
                                   "train_bytes"))
        if r["mixed_quality"] < r["quality"] - 1e-12:
            failures.append((cell, f"mixed-dim quality "
                                   f"{r['mixed_quality']:.8f} fell below the "
                                   f"uniform-dim plan's {r['quality']:.8f}"))
        if r["budget_frac"] == MIXED_STRICT_FRAC \
                and not r["mixed_quality"] > r["quality"]:
            failures.append((cell, f"mixed-dim quality "
                                   f"{r['mixed_quality']:.8f} does not "
                                   f"strictly beat the uniform-dim plan's "
                                   f"{r['quality']:.8f} at the "
                                   f"{MIXED_STRICT_FRAC:g}x budget"))
        if not r["compositional_complementary"]:
            failures.append((cell, "a compositional choice failed "
                                   "is_complementary"))
    for arch, cells in by_arch.items():
        cells = sorted(cells, key=lambda r: r["budget_frac"])
        for a, b in zip(cells, cells[1:]):
            if b["quality"] < a["quality"] - 1e-12:
                failures.append(
                    (f"{arch}/b{b['budget_frac']:g}",
                     f"quality {b['quality']:.6f} dropped below the "
                     f"smaller budget's {a['quality']:.6f}"))
            if b["mixed_quality"] < a["mixed_quality"] - 1e-12:
                failures.append(
                    (f"{arch}/b{b['budget_frac']:g}",
                     f"mixed-dim quality {b['mixed_quality']:.6f} dropped "
                     f"below the smaller budget's "
                     f"{a['mixed_quality']:.6f}"))
    return failures


def summarize(report: dict) -> dict:
    """The compact mirror (``BENCH_plan_summary.json`` beside the report):
    totals + acceptance booleans, the reference's schema — keep keys
    stable."""
    rows = report["rows"]
    failed = report.get("checks_failed", [])
    strict = [r for r in rows if r["budget_frac"] == MIXED_STRICT_FRAC]
    return {
        "bench": "plan",
        "source": os.path.join(ART, "BENCH_plan.json"),
        "cells": len(rows),
        "archs": report["archs"],
        "budget_fracs": report["budget_fracs"],
        "quality_mean": sum(r["quality"] for r in rows) / max(1, len(rows)),
        "mixed_quality_mean": sum(r["mixed_quality"] for r in rows)
        / max(1, len(rows)),
        "parked_total": sum(r["parked"] + r["mixed_parked"] for r in rows),
        "acceptance": {
            "budget_respected": all(r["plan_bytes"] <= r["budget_bytes"]
                                    and r["mixed_bytes"] <= r["budget_bytes"]
                                    for r in rows),
            "built_bytes_match": all(r["built_bytes"] == r["plan_bytes"]
                                     and r["mixed_built_bytes_ok"]
                                     for r in rows),
            "beats_uniform_hash": all(r["quality"] > r["uniform_quality"]
                                      for r in rows),
            "mixed_strictly_beats_unidim": all(
                r["mixed_quality"] > r["quality"] for r in strict)
            and bool(strict),
            "complementary": all(r["compositional_complementary"]
                                 for r in rows),
            "all_checks_passed": not failed,
        },
        "checks_failed": failed,
    }


def rows(device=None):
    """Fast planner section for ``benchmarks.run``: one arch, two budgets,
    a short stats stream — catches wiring rot, not statistics.  The
    planner runs on the host whatever ``device`` the harness names."""
    out = []
    cfg, stats = _stats_for("dlrm-criteo", num_batches=6, batch_size=256)
    for frac in (0.05, 0.25):
        r = _plan_cell("dlrm-criteo", cfg, stats, frac, save=False)
        ok = (r["plan_bytes"] <= r["budget_bytes"]
              and r["quality"] > r["uniform_quality"]
              and r["mixed_bytes"] <= r["budget_bytes"]
              and r["mixed_built_bytes_ok"]
              and r["mixed_quality"] >= r["quality"] - 1e-12
              and r["compositional_complementary"])
        name = f"plan/{r['arch']}/b{frac:g}" + ("" if ok else "/ERROR")
        out.append((name, r["solve_ms"] * 1e3,
                    f"quality={r['quality']:.4f};"
                    f"mixed={r['mixed_quality']:.4f};"
                    f"uniform={r['uniform_quality']:.4f};"
                    f"bytes={r['plan_bytes']}/{r['budget_bytes']};"
                    f"parked={r['parked']}+{r['mixed_parked']}"))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stats-batches", type=int,
                    default=int(os.environ.get("REPRO_BENCH_STATS_BATCHES", 24)),
                    help="synthetic Criteo batches streamed into the "
                         "frequency histograms")
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--no-save-plans", dest="save_plans",
                    action="store_false", default=True,
                    help="skip writing the solved plans to artifacts/plans/")
    ap.add_argument("--out", default=os.path.join(ART, "BENCH_plan.json"))
    ap.add_argument("--summary-out", default=os.path.join(ART, "BENCH_plan_summary.json"),
                    help="compact mirror (totals + acceptance booleans)")
    args = ap.parse_args(argv)

    print("name,us_per_call,derived")
    try:
        report = bench(args.stats_batches, args.batch_size, args.save_plans)
    except Exception as e:
        print(f"plan_bench/ERROR,0,{repr(e)[:160]}")
        return 1
    for r in report["rows"]:
        print(f"plan/{r['arch']}/b{r['budget_frac']:g},"
              f"{r['solve_ms'] * 1e3:.0f},"
              f"quality={r['quality']:.6f};"
              f"mixed={r['mixed_quality']:.6f};"
              f"uniform={r['uniform_quality']:.6f};"
              f"bytes={r['plan_bytes']}/{r['budget_bytes']};"
              f"parked={r['parked']}+{r['mixed_parked']};"
              f"dims={'+'.join(f'{k}:{v}' for k, v in sorted(r['mixed_dims'].items(), key=lambda kv: int(kv[0])))};"
              f"kinds={'+'.join(f'{k}:{v}' for k, v in sorted(r['kinds'].items()))}")
        sys.stdout.flush()
    failures = check(report)
    report["checks_failed"] = [f"{n}: {m}" for n, m in failures]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1, default=float)
    with open(args.summary_out, "w") as f:
        json.dump(summarize(report), f, indent=1, default=float)
    for name, msg in failures:
        print(f"plan/check/{name}/ERROR,0,{msg}")
    if failures:
        print(f"# {len(failures)} plan_bench check(s) failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

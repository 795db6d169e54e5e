"""Budget → plan → model: the planner-driven compression sweep, as the JAX
package's ``examples/compression_sweep.py``.

The paper's Fig. 5 trade-off (params vs quality), but instead of
hand-enumerating per-feature specs, each point asks ``repro_torch.plan``
for the best allocation at a byte budget: frequency stats are streamed
from the port's synthetic Criteo generator (drawn on the CPU), the
Lagrangian-greedy knapsack picks full / hash / QR / mixed-radix per
feature, and the resulting ``MemoryPlan`` drops straight into
``DLRMConfig.embedding``.

Each budget prints the planner's analytic quality proxy next to the
*trained* held-out loss of (a) the planned model and (b) the
uniform-hashing control at the same budget.  The proxy's job is to rank
allocations without training, so the last line says, per budget, whether
the two orderings agree (a report, not a gate).

Every model trains ``--steps`` Adagrad (1e-2) steps at batch 256 from
parameters drawn on the CPU (seed 0) on CPU-drawn batches copied to
``--device``, and is scored on the held-out steps 10,000-10,007.

Run: PYTHONPATH=src python -m repro_torch.examples.compression_sweep [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.benchmarks.paper_tables import heldout, to_device, train
from repro_torch.core import EmbeddingSpec
from repro_torch.data.criteo import CriteoSpec, batch_at
from repro_torch.models.dlrm import DLRMConfig, dlrm_init, dlrm_loss_fn, dlrm_num_params
from repro_torch.optim.optimizers import adagrad
from repro_torch.plan import build_plan, full_table_bytes, stats_from_criteo, uniform_hash_plan

SIZES = (1000, 200, 50000, 12000, 31, 24, 12517, 633, 3, 931)
SPEC = CriteoSpec(table_sizes=SIZES, zipf=1.5, noise=0.5)
DIM = 16
BUDGET_FRACS = (0.05, 0.125, 0.25, 0.5)
STEPS = 250
BATCH = 256
HELDOUT = range(10_000, 10_008)
STATS = {"num_batches": 16, "batch_size": 512}

__all__ = ["SIZES", "SPEC", "DIM", "BUDGET_FRACS", "STEPS", "BATCH", "HELDOUT", "STATS",
           "solve", "train_model", "sweep", "agreement", "main"]


def solve(budget_fracs=BUDGET_FRACS):
    """``[(frac, plan, uniform)]``: per budget, the planner's plan and the
    uniform-hash control, solved on the CPU-drawn stats."""
    stats = stats_from_criteo(SPEC, **STATS)
    full = full_table_bytes(SIZES, DIM)
    out = []
    for frac in budget_fracs:
        budget = int(full * frac)
        uni = uniform_hash_plan(stats, DIM, budget, arch="dlrm-criteo")
        plan = build_plan(stats, DIM, budget, arch="dlrm-criteo", baseline=uni)
        out.append((frac, plan, uni))
    return out


def train_model(embedding, *, steps=STEPS, batch=BATCH, device="cuda") -> dict:
    """One model trained and scored: its parameter count, held-out loss,
    every step's training loss and the host clock's µs per step."""
    cfg = DLRMConfig(table_sizes=SIZES, emb_dim=DIM, embedding=embedding)

    def loss_fn(p, b):
        return dlrm_loss_fn(p, b, cfg)

    params = dlrm_init(cfg, torch.Generator().manual_seed(0), "cpu")
    run = train(loss_fn, adagrad(1e-2), params, lambda i: batch_at(0, i, batch, SPEC, "cpu"),
                steps, device)
    batches = [to_device(batch_at(0, i, batch, SPEC, "cpu"), device) for i in HELDOUT]
    loss, _ = heldout(loss_fn, run.state["params"], batches)
    return {"params": dlrm_num_params(cfg), "loss": loss, "train_losses": run.losses,
            "us_per_step": run.us_per_step}


def sweep(*, steps=STEPS, budget_fracs=BUDGET_FRACS, device="cuda") -> list[dict]:
    """One row per trained model: the full tables, then per budget the
    plan and the uniform-hash control (with the ``MemoryPlan``)."""
    full = dict(train_model(EmbeddingSpec(kind="full"), steps=steps, device=device),
                name="full", ratio=1.0, proxy=1.0)
    rows = [full]
    for frac, plan, uni in solve(budget_fracs):
        for name, p in ((f"plan/{frac:g}x", plan), (f"uniform-hash/{frac:g}x", uni)):
            r = train_model(p, steps=steps, device=device)
            rows.append(dict(r, name=name, frac=frac, ratio=full["params"] / r["params"],
                             proxy=p.quality, plan=p,
                             kinds="+".join(f"{k}:{v}" for k, v in
                                            sorted(p.summary()["kinds"].items()))))
    return rows


def agreement(rows) -> dict:
    """Per budget: whether the proxy's order of plan vs uniform-hash (higher
    quality first) is the trained losses' order (lower loss first)."""
    by = {r["name"]: r for r in rows}
    out = {}
    for r in rows:
        if not r["name"].startswith("plan/"):
            continue
        u = by["uniform-hash/" + r["name"].split("/", 1)[1]]
        out[r["frac"]] = (r["proxy"] > u["proxy"]) == (r["loss"] < u["loss"])
    return out


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--budgets", default=",".join(f"{f:g}" for f in BUDGET_FRACS),
                    help="comma list of budget fractions of the full f32 tables")
    args = ap.parse_args(argv)
    fracs = tuple(float(f) for f in args.budgets.split(","))
    rows = sweep(steps=args.steps, budget_fracs=fracs, device=args.device)
    print(f"{'treatment':26s} {'params':>10s} {'ratio':>6s} {'proxy':>8s} {'loss':>8s}")
    for r in rows:
        tail = f"   [{r['kinds']}]" if r["name"].startswith("plan/") else ""
        print(f"{r['name']:26s} {r['params']:>10,} {r['ratio']:>6.1f} {r['proxy']:>8.4f} "
              f"{r['loss']:>8.4f}{tail}")
    agree = agreement(rows)
    print("proxy order vs trained order (plan vs uniform-hash): " + ", ".join(
        f"{f:g}x {'agree' if a else 'disagree'}" for f, a in agree.items())
        + f" ({sum(agree.values())} of {len(agree)} agree)")
    return rows


if __name__ == "__main__":
    main()

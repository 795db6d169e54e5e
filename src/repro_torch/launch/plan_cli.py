"""Shared ``--plan`` / ``--plan-budget-mb`` CLI resolution for the port's
launchers, as the JAX package's ``launch/plan_cli.py``.

``--plan <path>`` loads a solved ``MemoryPlan`` artifact (written by either
package); ``--plan-budget-mb <float>`` synthesizes one on the fly against
the arch's table sizes (the port's synthetic Criteo frequency stream,
drawn on the CPU) and saves it under ``artifacts/plans/`` so the decision
is auditable and reusable.  The two flags are mutually exclusive; both
yield a plan the arch's ``config(plan=...)`` consumes.
"""

from __future__ import annotations

__all__ = ["add_plan_args", "resolve_plan_args"]


def add_plan_args(ap) -> None:
    ap.add_argument("--plan", default=None,
                    help="path to a MemoryPlan JSON: per-feature "
                         "table strategies replace the uniform --embedding")
    ap.add_argument("--plan-budget-mb", type=float, default=None,
                    help="synthesize a memory plan on the fly at this table "
                         "byte budget (saved under artifacts/plans/)")
    ap.add_argument("--plan-dims", default=None,
                    help="width ladder for --plan-budget-mb: 'mixed' for "
                         "the default {D/4, D/2, D} mixed-dimension axis, "
                         "or an explicit comma list like '4,8,16' "
                         "(default: uniform width = the arch's emb_dim)")


def resolve_plan_args(mod, args):
    """A MemoryPlan from the CLI flags, or None when neither is given."""
    plan_path_arg = getattr(args, "plan", None)
    budget_mb = getattr(args, "plan_budget_mb", None)
    if plan_path_arg is None and budget_mb is None:
        if getattr(args, "plan_dims", None) is not None:
            raise SystemExit("--plan-dims needs --plan-budget-mb (it sets "
                             "the width ladder for plan synthesis)")
        return None
    if plan_path_arg is not None and budget_mb is not None:
        raise SystemExit("--plan and --plan-budget-mb are mutually exclusive")
    if getattr(mod, "FAMILY", "lm") != "rec":
        # only the rec configs grow a plan= kwarg; fail with intent, not a
        # TypeError from config()
        raise SystemExit("--plan/--plan-budget-mb size categorical tables; "
                         f"{args.arch} is not a rec-family arch")
    from ..plan import MemoryPlan, dim_ladder, plan_for_config, plan_path
    if plan_path_arg is not None:
        if getattr(args, "plan_dims", None) is not None:
            raise SystemExit("--plan-dims only applies when synthesizing "
                             "via --plan-budget-mb (a loaded plan already "
                             "fixed its widths)")
        plan = MemoryPlan.load(plan_path_arg)
        print(f"plan: loaded {plan_path_arg} "
              f"({plan.total_bytes / 2**20:.2f} MiB of "
              f"{plan.budget_bytes / 2**20:.2f} MiB budget, "
              f"quality {plan.quality:.4f})")
        return plan
    budget = int(budget_mb * 2 ** 20)
    cfg = mod.config(reduced=getattr(args, "reduced", True))
    dims_arg = getattr(args, "plan_dims", None)
    if dims_arg is None:
        dims = None
    elif dims_arg == "mixed":
        dims = dim_ladder(cfg.emb_dim)
    else:
        dims = tuple(int(d) for d in dims_arg.split(","))
    plan = plan_for_config(cfg, budget, arch=args.arch, dims=dims)
    out = plan.save(plan_path(args.arch, budget))
    s = plan.summary()
    print(f"plan: solved {args.arch} at {budget_mb:g} MiB "
          f"({s['budget_frac_of_full']:.3f}x full tables) -> {out}")
    print(f"plan: quality {plan.quality:.4f} vs uniform-hash "
          f"{plan.baseline_quality:.4f}; kinds {s['kinds']}; "
          f"dims {s['dims']}; parked upgrades {s['parked']}")
    return plan

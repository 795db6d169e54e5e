#!/usr/bin/env python3
"""The JAX package's memory planner on the port's stats, written down for
the machine that has no JAX.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/plan_reference.py [--out PATH]

It draws the frequency stats through the port (``repro_torch.plan.freq``,
the port's synthetic Criteo stream drawn on the CPU), checks that the JAX
package's ``stats_from_batches`` gives the same stats from the same
batches, and solves with the JAX package's planner (``repro.plan``) on
them:

- ``full_width``: full-width DLRM-Criteo (26 Kaggle tables, D=16), 24
  batches of 512, a budget of 0.125 x the full f32 tables, the width
  ladder {4, 8, 16} — the plan ``chip_smoke.py`` ``[plan]`` solves with the
  port on the card and holds to this one;
- ``sweep``: ``plan_bench``'s 8 reduced cells (DLRM and DCN x budgets
  0.05, 0.125, 0.25, 0.5) at its default stream (24 batches of 512), each
  cell's uniform-hash control, uniform-width plan and mixed-width plan;
- ``reference_stream``: the reduced DLRM-Criteo on the JAX package's own
  stream at 6 batches of 256 (``tests/test_plan.py``'s bench run), whose
  mixed-width plan falls below the uniform-width one at the 0.05 budget:
  the greedy solver's fault (``plan/solver.py``), reproduced by the port.

Every plan is stored as the plan JSON both packages read, with the sha1
of the stats it was solved on.  The default ``--out`` is
``src/repro_torch/benchmarks/reference_plans.json``
(``tests/test_torch_plan.py`` holds it to what the JAX planner gives).
Takes about 20 s on one CPU core.  Imports both packages.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402

from repro import plan as jplan  # noqa: E402
from repro.configs import dlrm_criteo as jdlrm  # noqa: E402
from repro.data.criteo import CriteoSpec as JCriteoSpec  # noqa: E402
from repro_torch import plan as tplan  # noqa: E402
from repro_torch.configs import dcn_criteo, dlrm_criteo  # noqa: E402
from repro_torch.data.criteo import CriteoSpec, batch_at  # noqa: E402

OUT = os.path.join(ROOT, "src", "repro_torch", "benchmarks", "reference_plans.json")
FULL_WIDTH = {"budget_frac": 0.125, "num_batches": 24, "batch_size": 512}
SWEEP = {"budget_fracs": [0.05, 0.125, 0.25, 0.5], "num_batches": 24, "batch_size": 512}
REFERENCE_STREAM = {"budget_fracs": [0.05, 0.125], "num_batches": 6, "batch_size": 256}


def stats_sha1(stats) -> str:
    """One hash of every feature's size, ids and probabilities."""
    h = hashlib.sha1()
    for st in stats:
        h.update(str(st.size).encode())
        h.update(np.ascontiguousarray(st.ids, np.int64).tobytes())
        h.update(np.ascontiguousarray(st.probs, np.float64).tobytes())
    return h.hexdigest()


def port_stats(sizes, num_batches: int, batch_size: int):
    """The port's stats (CPU-drawn stream) and the JAX package's stats of the
    same batches, which must be equal; returned as the JAX package's type."""
    spec = CriteoSpec(table_sizes=tuple(sizes), zipf=1.5, noise=0.5)
    stats = tplan.stats_from_criteo(spec, num_batches=num_batches, batch_size=batch_size)
    again = jplan.stats_from_batches(
        (batch_at(0, s, batch_size, spec, device="cpu")["sparse"].numpy()
         for s in range(num_batches)), sizes)
    for a, b in zip(stats, again):
        if not (a.size == b.size and np.array_equal(a.ids, b.ids)
                and np.array_equal(a.probs, b.probs)):
            raise SystemExit("the JAX package's stats of the port's batches differ from the port's")
    return again


def _plan(p) -> dict:
    return json.loads(p.to_json())


def full_width() -> dict:
    cfg = dlrm_criteo.config(reduced=False)
    t = time.perf_counter()
    stats = port_stats(cfg.table_sizes, FULL_WIDTH["num_batches"], FULL_WIDTH["batch_size"])
    stats_s = time.perf_counter() - t
    budget = int(jplan.full_table_bytes(cfg.table_sizes, cfg.emb_dim)
                 * FULL_WIDTH["budget_frac"])
    t = time.perf_counter()
    plan = jplan.build_plan(stats, cfg.emb_dim, budget, arch=cfg.name,
                            dims=jplan.dim_ladder(cfg.emb_dim))
    solve_s = time.perf_counter() - t
    s = plan.summary()
    print(f"full width: {s['kinds']} widths {s['dims']}, {plan.total_bytes} B f32 of "
          f"{budget}, {sum(t.serve_bytes_int8 for t in plan.tables)} B int8; stats "
          f"{stats_s:.1f} s, solve {solve_s:.1f} s (JAX package, this CPU)")
    return dict(FULL_WIDTH, arch=cfg.name, dims=list(jplan.dim_ladder(cfg.emb_dim)),
                budget_bytes=budget, stats_sha1=stats_sha1(stats), plan=_plan(plan))


def _cells(arch, cfg, stats, fracs) -> list:
    """``plan_bench._plan_cell``'s three solves per budget."""
    cells = []
    for frac in fracs:
        budget = int(jplan.full_table_bytes(cfg.table_sizes, cfg.emb_dim) * frac)
        uniform = jplan.uniform_hash_plan(stats, cfg.emb_dim, budget, arch=arch)
        plan = jplan.build_plan(stats, cfg.emb_dim, budget, arch=arch, baseline=uniform)
        mixed = jplan.build_plan(stats, cfg.emb_dim, budget, arch=f"{arch}-mixed",
                                 baseline=uniform, dims=jplan.dim_ladder(cfg.emb_dim))
        print(f"{arch} b{frac:g}: quality {plan.quality:.8f} mixed {mixed.quality:.8f} "
              f"uniform hash {uniform.quality:.8f}")
        cells.append({"arch": arch, "budget_frac": frac, "budget_bytes": budget,
                      "uniform": _plan(uniform), "plan": _plan(plan), "mixed": _plan(mixed)})
    return cells


def sweep() -> dict:
    cells, sha = [], {}
    for mod in (dlrm_criteo, dcn_criteo):
        cfg = mod.config(reduced=True)
        stats = port_stats(cfg.table_sizes, SWEEP["num_batches"], SWEEP["batch_size"])
        sha[mod.ARCH] = stats_sha1(stats)
        cells += _cells(mod.ARCH, cfg, stats, SWEEP["budget_fracs"])
    return dict(SWEEP, stats_sha1=sha, cells=cells)


def reference_stream() -> dict:
    cfg = jdlrm.config(reduced=True)
    spec = JCriteoSpec(table_sizes=cfg.table_sizes, zipf=1.5, noise=0.5)
    stats = jplan.stats_from_criteo(spec, num_batches=REFERENCE_STREAM["num_batches"],
                                    batch_size=REFERENCE_STREAM["batch_size"])
    return dict(REFERENCE_STREAM, arch=jdlrm.ARCH, stats_sha1=stats_sha1(stats),
                cells=_cells(jdlrm.ARCH, cfg, stats, REFERENCE_STREAM["budget_fracs"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    t = time.perf_counter()
    report = {"tool": "tools/plan_reference.py", "full_width": full_width(),
              "sweep": sweep(), "reference_stream": reference_stream()}
    print(f"{time.perf_counter() - t:.1f} s")
    with open(args.out, "w") as f:
        f.write(json.dumps(report, indent=1, sort_keys=True) + "\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

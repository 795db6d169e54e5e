#!/usr/bin/env python3
"""The JAX package's compression sweep (``examples/compression_sweep.py``)
on the port's stream, written down for the machine that has no JAX.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/sweep_reference.py [--steps N] [--out PATH]

It draws the sweep's frequency stats through the port
(``repro_torch.plan.stats_from_criteo``, 16 CPU-drawn batches of 512),
checks that the JAX package's ``stats_from_batches`` gives the same stats
from the same batches, and solves each budget with the JAX package's
planner (``build_plan`` against ``uniform_hash_plan``).  Then it trains
the sweep's nine models with the JAX package (``make_train_step`` jitted
once per model, Adagrad 1e-2, batch 256) from the port's initial
parameters (drawn on the CPU from seed 0, carried into JAX) on the port's
CPU-drawn batches, scores each on the held-out steps 10,000-10,007, and
runs the port's sweep on the CPU on the same inputs beside it.

It writes every plan (the plan JSON both packages read), both held-out
losses per model, their gap and each model's tolerance to ``--out``, by
default ``src/repro_torch/benchmarks/reference_sweep.json``, which
``chip_smoke.py`` ``[sweep]`` holds the card to: plans field for field,
held-out losses within the tolerance of ``paper_tables_reference.py``
(0.02, or 1.5 times the model's JAX-vs-port-CPU gap where that is larger:
the free-running trajectories split after a few steps).  Takes about a
minute on the CPU.  Imports both packages.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from paper_tables_reference import BASE_TOL, tolerance  # noqa: E402
from plan_reference import port_stats, stats_sha1  # noqa: E402
from repro import plan as jplan  # noqa: E402
from repro.core import EmbeddingSpec as JSpec  # noqa: E402
from repro.models import dlrm as jdlrm  # noqa: E402
from repro.optim.optimizers import adagrad as jadagrad  # noqa: E402
from repro.train.loop import init_state as jinit_state  # noqa: E402
from repro.train.loop import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.convert import state_to_numpy  # noqa: E402
from repro_torch.core import EmbeddingSpec  # noqa: E402
from repro_torch.data.criteo import batch_at  # noqa: E402
from repro_torch.examples import compression_sweep as sw  # noqa: E402
from repro_torch.models.dlrm import DLRMConfig, dlrm_init  # noqa: E402

import torch  # noqa: E402

OUT = os.path.join(ROOT, "src", "repro_torch", "benchmarks", "reference_sweep.json")


def _batch(step: int):
    return {k: jnp.asarray(v.numpy())
            for k, v in batch_at(0, step, sw.BATCH, sw.SPEC, device="cpu").items()}


def jax_train(jembedding, tembedding, steps: int) -> dict:
    """The reference's ``train`` on the port's initial parameters and batches."""
    jcfg = jdlrm.DLRMConfig(table_sizes=sw.SIZES, emb_dim=sw.DIM, embedding=jembedding)
    tcfg = DLRMConfig(table_sizes=sw.SIZES, emb_dim=sw.DIM, embedding=tembedding)
    params = jax.tree.map(jnp.asarray, state_to_numpy(
        dlrm_init(tcfg, torch.Generator().manual_seed(0), "cpu")))
    want = jax.eval_shape(lambda k: jdlrm.dlrm_init(k, jcfg), jax.random.PRNGKey(0))
    if jax.tree.structure(want) != jax.tree.structure(params):
        raise ValueError("the port's parameter tree is not the reference's")
    opt = jadagrad(1e-2)
    state = jinit_state(params, opt)
    step = jax.jit(jmake_train_step(lambda p, b: jdlrm.dlrm_loss_fn(p, b, jcfg), opt))
    for i in range(steps):
        state, _ = step(state, _batch(i))
    ev = jax.jit(lambda p, b: jdlrm.dlrm_loss_fn(p, b, jcfg))
    loss = float(np.mean([float(ev(state["params"], _batch(i))[0]) for i in sw.HELDOUT]))
    return {"params": jdlrm.dlrm_num_params(jcfg), "loss": loss}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=sw.STEPS)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    stats = port_stats(sw.SIZES, sw.STATS["num_batches"], sw.STATS["batch_size"])
    full = jplan.full_table_bytes(sw.SIZES, sw.DIM)
    port_rows = {r["name"]: r for r in sw.sweep(steps=args.steps, device="cpu")}
    models = [("full", JSpec(kind="full"), EmbeddingSpec(kind="full"), None)]
    for frac in sw.BUDGET_FRACS:
        budget = int(full * frac)
        uni = jplan.uniform_hash_plan(stats, sw.DIM, budget, arch="dlrm-criteo")
        plan = jplan.build_plan(stats, sw.DIM, budget, arch="dlrm-criteo", baseline=uni)
        for name, p in ((f"plan/{frac:g}x", plan), (f"uniform-hash/{frac:g}x", uni)):
            models.append((name, p, port_rows[name]["plan"],
                           {"frac": frac, "budget_bytes": budget,
                            "plan": json.loads(p.to_json())}))
    rows = []
    print(f"{'treatment':26s} {'reference':>10s} {'port cpu':>10s} {'|Δ|':>10s} {'tol':>6s}")
    for name, jemb, temb, extra in models:
        ref = jax_train(jemb, temb, args.steps)
        port = port_rows[name]
        if ref["params"] != port["params"]:
            raise SystemExit(f"{name}: {port['params']} parameters, the reference "
                             f"{ref['params']}")
        gap = abs(port["loss"] - ref["loss"])
        row = {"name": name, "params": ref["params"], "loss": ref["loss"],
               "port_cpu_loss": port["loss"], "abs_dloss": gap, "tol": tolerance(gap),
               "proxy": float(extra["plan"]["quality"]) if extra else 1.0}
        row.update(extra or {})
        rows.append(row)
        print(f"{name:26s} {ref['loss']:10.6f} {port['loss']:10.6f} {gap:10.6f} "
              f"{tolerance(gap):6.4f}", flush=True)
    largest = max(r["abs_dloss"] for r in rows)
    print(f"largest |Δ| {largest:.6f} (base tolerance {BASE_TOL}); "
          f"{time.perf_counter() - t0:.0f} s")
    report = {"tool": "tools/sweep_reference.py", "steps": args.steps, "batch": sw.BATCH,
              "heldout": [sw.HELDOUT.start, sw.HELDOUT.stop], "stats": dict(
                  sw.STATS, stats_sha1=stats_sha1(stats)),
              "base_tolerance": BASE_TOL, "largest_abs_dloss": largest, "rows": rows}
    with open(args.out, "w") as f:
        f.write(json.dumps(report, indent=1, sort_keys=True) + "\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

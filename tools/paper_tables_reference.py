#!/usr/bin/env python3
"""The JAX package's §5 training and scoring on the port's stream, beside
the port on the CPU, for any row of ``repro_torch.benchmarks.paper_tables``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/paper_tables_reference.py \\
        [--only SUBSTR] [--steps N] [--out PATH] [--write-reference] \\
        [--horizon N | --lockstep N]

For each row it takes the port's initial parameters, drawn on the CPU
(``paper_tables.setup``), carried into JAX, and the port's CPU-drawn
batches as numpy, and runs the reference on them: ``repro.configs.*.api``,
``make_train_step`` jitted once per row, ``loss_fn`` jitted once per row
for the held-out batches (steps 10,000-10,011).  That is the experiment
``paper_tables`` runs on the card.  Then it runs the port on the CPU on
the same inputs (``paper_tables.run_row(device="cpu")``, which draws the
same parameters and batches).  It prints each row's held-out BCE from
both, their difference and the row's tolerance, and writes every number
to ``--out`` (JSON).

The tolerance a card row is held to against the reference is 0.02
held-out BCE, or 1.5 times the row's JAX-vs-port-CPU difference where that
difference is larger.  ``--write-reference`` (a run of all 30 rows at 400
steps) writes the reference's rows, with the port's CPU loss and the
tolerance, to ``src/repro_torch/benchmarks/reference_rows.json``, which
``chip_smoke.py`` holds the card against.

``--horizon N`` runs the selected rows on the reference's own parameters
and batches (``a.init``, ``a.batch_fn``), carried into the port through
``convert``, as ``tests/test_torch_paper_tables.py`` does, and prints
after each of the first N steps the larger relative difference of the
port's held-out BCE and accuracy from the reference's: the short horizon
over which the two agree.

``--lockstep N`` runs the selected rows' first N steps in JAX and in the
port side by side instead, and prints per step how many parameter
elements are more than 1e-4 apart and the largest difference, and at
steps 1, 5, 10, 20, 50, 100, 200 and 400 (up to N) both held-out BCEs and
accuracies: where the two trajectories split.

Imports both packages; runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import dcn_criteo as jdcn  # noqa: E402
from repro.configs import dlrm_criteo as jdlrm  # noqa: E402
from repro.train.loop import init_state as jinit_state  # noqa: E402
from repro.train.loop import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.benchmarks import paper_tables as pt  # noqa: E402
from repro_torch.convert import params_from_jax, state_to_numpy  # noqa: E402

JMODULES = {"dlrm": jdlrm, "dcn": jdcn}
REFERENCE_ROWS = os.path.join(ROOT, "src", "repro_torch", "benchmarks", "reference_rows.json")
BASE_TOL = 0.02
LOCKSTEP_EVAL = (1, 5, 10, 20, 50, 100, 200, 400)


def tolerance(gap: float) -> float:
    """A card row's tolerance against the reference from its JAX-vs-port-CPU gap."""
    return BASE_TOL if gap <= BASE_TOL else 1.5 * gap


class ReferenceRow:
    """One row's reference side: the JAX api of the row's config, its
    jitted step and loss, and the port's CPU-drawn inputs as JAX arrays."""

    def __init__(self, spec, seed: int):
        mod, jmod = pt.MODULES[spec.net], JMODULES[spec.net]
        _, self.port_api, port_params = pt.setup(mod, seed=seed, **spec.kw)
        self.api = jmod.api(jmod.config(reduced=True, **spec.kw))
        self.params = jax.tree.map(jnp.asarray, state_to_numpy(port_params))
        want = jax.eval_shape(self.api.init, jax.random.PRNGKey(0))
        if jax.tree.structure(want) != jax.tree.structure(self.params) or [
                w.shape for w in jax.tree.leaves(want)] != [
                p.shape for p in jax.tree.leaves(self.params)]:
            raise ValueError(f"{spec.name}: the port's parameter tree is not the reference's")
        self.n_params = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(self.params))
        self.step = jax.jit(jmake_train_step(self.api.loss_fn, self.api.optimizer))
        self.loss = jax.jit(self.api.loss_fn)
        self.heldout_batches = [self.batch(s) for s in pt.HELDOUT]

    def batch(self, step: int):
        batch = self.port_api.batch_fn(step, pt.SHAPE)
        return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}

    def heldout(self, params):
        losses, accs = [], []
        for b in self.heldout_batches:
            loss, metrics = self.loss(params, b)
            losses.append(float(loss))
            accs.append(float(metrics["acc"]))
        return float(np.mean(losses)), float(np.mean(accs))

    def run(self, steps: int) -> dict:
        state = jinit_state(self.params, self.api.optimizer)
        losses = []
        t = time.perf_counter()
        for s in range(steps):
            state, metrics = self.step(state, self.batch(s))
            losses.append(metrics["loss"])
        losses = [float(x) for x in losses]
        loss, acc = self.heldout(state["params"])
        return {"loss": loss, "acc": acc, "params": self.n_params, "loss_step_0": losses[0],
                "loss_last_10": float(np.mean(losses[-10:])),
                "seconds": time.perf_counter() - t}


def compare(specs, steps: int, seed: int) -> dict:
    out = {}
    print(f"{'row':32s} {'reference':>10s} {'port cpu':>10s} {'|Δ|':>10s} {'tol':>6s}")
    for spec in specs:
        ref = ReferenceRow(spec, seed).run(steps)
        r = pt.run_row(pt.MODULES[spec.net], steps=steps, seed=seed, device="cpu", **spec.kw)
        port = {"loss": r.loss, "acc": r.acc, "params": r.params,
                "loss_step_0": r.train_losses[0],
                "loss_last_10": float(np.mean(r.train_losses[-10:]))}
        if port["params"] != ref["params"]:
            raise ValueError(f"{spec.name}: {port['params']} parameters, the reference "
                             f"{ref['params']}")
        gap = abs(port["loss"] - ref["loss"])
        out[spec.name] = {"reference": ref, "port_cpu": port, "abs_dloss": gap,
                          "abs_dacc": abs(port["acc"] - ref["acc"]), "tol": tolerance(gap)}
        print(f"{spec.name:32s} {ref['loss']:10.6f} {port['loss']:10.6f} {gap:10.6f} "
              f"{tolerance(gap):6.4f}", flush=True)
    return out


def lockstep(specs, steps: int, seed: int) -> dict:
    """Both trajectories side by side: per step the parameter elements
    more than 1e-4 apart and the largest difference, and held-out scores
    at ``LOCKSTEP_EVAL`` steps."""
    from repro_torch.train.loop import init_state, make_train_step

    out = {}
    for spec in specs:
        ref = ReferenceRow(spec, seed)
        _, api, params = pt.setup(pt.MODULES[spec.net], seed=seed, **spec.kw)
        jstate = jinit_state(ref.params, ref.api.optimizer)
        tstate = init_state(params, api.optimizer)
        tstep = make_train_step(api.loss_fn, api.optimizer)
        tbatches = [api.batch_fn(s, pt.SHAPE) for s in pt.HELDOUT]
        rows = []
        for s in range(steps):
            jstate, _ = ref.step(jstate, ref.batch(s))
            tstate, _ = tstep(tstate, api.batch_fn(s, pt.SHAPE))
            diffs = [np.abs(np.asarray(a) - b).ravel() for a, b in zip(
                jax.tree.leaves(jstate["params"]),
                jax.tree.leaves(state_to_numpy(tstate["params"])))]
            d = np.concatenate(diffs)
            row = {"step": s, "apart_1e-4": int((d > 1e-4).sum()), "max_abs": float(d.max())}
            if s + 1 in LOCKSTEP_EVAL:
                row["reference"] = ref.heldout(jstate["params"])
                row["port_cpu"] = pt.heldout(api.loss_fn, tstate["params"], tbatches)
            rows.append(row)
            print(f"{spec.name} step {s}: {row['apart_1e-4']} elements > 1e-4 apart, max "
                  f"{row['max_abs']:.3e}" + (f"; held-out after {s + 1} steps: reference "
                                             f"{row['reference']}, port {row['port_cpu']}"
                                             if "reference" in row else ""), flush=True)
        out[spec.name] = rows
    return out


def horizon(specs, steps: int, seed: int) -> dict:
    """On the reference's parameters and batches: after each of the first
    ``steps`` steps, the larger relative difference of the port's held-out
    BCE and accuracy from the reference's."""
    import torch

    from repro_torch.train.loop import init_state, make_train_step

    def to_torch(b):
        return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}

    out = {}
    for spec in specs:
        jmod = JMODULES[spec.net]
        a = jmod.api(jmod.config(reduced=True, **spec.kw))
        params = a.init(jax.random.PRNGKey(seed))
        held = [a.batch_fn(s, pt.SHAPE) for s in pt.HELDOUT]
        theld = [to_torch(b) for b in held]
        jstep = jax.jit(jmake_train_step(a.loss_fn, a.optimizer))
        jloss = jax.jit(a.loss_fn)
        jstate = jinit_state(params, a.optimizer)
        _, api, _ = pt.setup(pt.MODULES[spec.net], seed=seed, **spec.kw)
        tstate = init_state(params_from_jax(jax.tree.map(np.asarray, params), "cpu"),
                            api.optimizer)
        tstep = make_train_step(api.loss_fn, api.optimizer)
        rel = []
        for s in range(steps):
            batch = a.batch_fn(s, pt.SHAPE)
            jstate, _ = jstep(jstate, batch)
            tstate, _ = tstep(tstate, to_torch(batch))
            scored = [jloss(jstate["params"], b) for b in held]
            ref = (float(np.mean([float(x) for x, _ in scored])),
                   float(np.mean([float(m["acc"]) for _, m in scored])))
            port = pt.heldout(api.loss_fn, tstate["params"], theld)
            rel.append(max(abs(p - r) / abs(r) for p, r in zip(port, ref)))
        out[spec.name] = rel
        print(f"{spec.name}: " + " ".join(f"{k + 1}:{v:.1e}" for k, v in enumerate(rel)),
              flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="", help="rows whose name contains this substring")
    ap.add_argument("--steps", type=int, default=pt.TRAIN_STEPS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join("artifacts", "bench_torch",
                                                  "reference_vs_port_cpu.json"))
    ap.add_argument("--write-reference", action="store_true")
    ap.add_argument("--lockstep", type=int, default=0)
    ap.add_argument("--horizon", type=int, default=0)
    args = ap.parse_args(argv)
    specs = [s for s in pt.row_specs() if args.only in s.name]
    if args.horizon:
        result = horizon(specs, args.horizon, args.seed)
    elif args.lockstep:
        result = lockstep(specs, args.lockstep, args.seed)
    else:
        result = compare(specs, args.steps, args.seed)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"steps": args.horizon or args.lockstep or args.steps, "seed": args.seed,
                   "rows": result},
                  f, indent=1)
    if args.write_reference:
        if args.horizon or args.lockstep or len(result) != len(pt.row_specs()) or args.steps != 400:
            raise SystemExit("--write-reference needs all 30 rows at 400 steps")
        rows = {name: {"loss": r["reference"]["loss"], "acc": r["reference"]["acc"],
                       "params": r["reference"]["params"],
                       "port_cpu_loss": r["port_cpu"]["loss"], "tol": r["tol"]}
                for name, r in result.items()}
        with open(REFERENCE_ROWS, "w") as f:
            json.dump({"steps": args.steps, "seed": args.seed, "batch": pt.BATCH,
                       "rows": rows}, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

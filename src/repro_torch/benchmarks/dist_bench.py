"""Wire bytes vs step time for the compression policies, as the JAX
package's ``benchmarks/dist_bench.py``.

Runs the paper's DLRM (reduced Criteo config, global batch 256) in a
world of ``--world`` processes under each compression policy, along each
path of ``--paths``: ``dp`` (``make_dp_train_step``: replicated
parameters, compressed all-reduce) and ``fsdp`` (``make_fsdp_train_step``:
compressed reduce-scatter, sharded optimizer state, parameter all-gather).
Per policy it reports the **accounted** per-device collective wire bytes
(``repro_torch.dist.accounting``), the **recorded** bytes — the ring
bytes of every tensor the step really handed to a collective
(``repro_torch.dist.wire``), which stand where the reference's HLO
analyzer stood — the measured step time, and the loss after ``--steps``
steps (compression must not wreck convergence).

Initial parameters and batches are drawn on the CPU and copied to each
rank's device.  ``--device cpu --backend gloo`` runs the world on the
host; ``--device cuda`` puts rank ``r`` on card ``r mod count`` (NCCL
takes one rank per card; ``--backend gloo`` puts several ranks on one
card, with the exchange through the host).

Artifacts: ``artifacts/bench_torch/BENCH_dist.json`` + CSV on stdout
(``name,us_per_call,derived``).  Exits 1 — with ``/ERROR`` rows — if the
run raises, if accounted and recorded bytes disagree by more than 10%,
or if the int8 policy fails to cut the recorded bytes below 0.3× of
``none`` on the dp path.

Usage::

    python -m repro_torch.benchmarks.dist_bench --world 8 --backend gloo --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ART = "artifacts/bench_torch"
# the reference's names: the recorded bytes stand where its HLO bytes stood
HLO_MATCH_TOL = 0.10
INT8_RATIO_BAR = 0.30
# loss / bce / acc means in the step
SCALAR_ALLREDUCES = 3
BATCH = 256

__all__ = ["HLO_MATCH_TOL", "INT8_RATIO_BAR", "SCALAR_ALLREDUCES", "bench", "check", "main"]


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rank(rank, world, steps, policies, paths, device_type, out):
    """One rank: every (path, policy) lane; rank 0 writes the rows to
    ``out``."""
    import torch

    from .. import tree
    from ..configs import dlrm_criteo
    from ..configs.common import Shape
    from ..dist import AUTO, accounting, wire
    from ..train.loop import (init_dp_state, init_fsdp_state, make_dp_train_step,
                              make_fsdp_train_step)

    if device_type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    cfg = dlrm_criteo.config(reduced=True)
    host = dlrm_criteo.api(cfg, device="cpu")
    api = dlrm_criteo.api(cfg, device=device)
    shape = Shape("bench", 1, BATCH, "train")
    params = tree.tree_map(lambda t: t.to(device), host.init(torch.Generator().manual_seed(0)))

    def batcher(i):
        return tree.tree_map(lambda t: t.to(device), host.batch_fn(i, shape))

    rows = []
    for path, name in [(path, name) for path in paths for name in policies]:
        pol = AUTO if name == "auto" else name
        if path == "dp":
            state = init_dp_state(params, api.optimizer, compress=pol)
            step = make_dp_train_step(api.loss_fn, api.optimizer, compress=pol)
            acct = accounting.dp_step_wire_bytes(params, pol, world,
                                                 scalar_allreduces=SCALAR_ALLREDUCES)
        else:
            state = init_fsdp_state(params, api.optimizer, policy=pol)
            step = make_fsdp_train_step(api.loss_fn, api.optimizer, None, params, policy=pol)
            acct = accounting.fsdp_step_wire_bytes(params, api.optimizer, world, pol,
                                                   scalar_allreduces=SCALAR_ALLREDUCES)
        state, m = step(state, batcher(0))          # first step outside the window
        _sync(device)
        wire.reset()
        t0 = time.perf_counter()
        for i in range(1, steps):
            state, m = step(state, batcher(i))
        _sync(device)
        timed = max(steps - 1, 1)
        us = (time.perf_counter() - t0) / timed * 1e6
        rec = wire.snapshot()
        rows.append({
            "path": path, "policy": name, "devices": world,
            "wire_bytes": acct["total_bytes"], "wire_bytes_grads": acct["grad_bytes"],
            "wire_bytes_param_gather": acct["param_gather_bytes"],
            "recorded_wire_bytes": rec["total_bytes"] / timed,
            "recorded_collectives": {k: v["calls"] / timed for k, v in rec["per_kind"].items()},
            "step_time_us": round(us, 1), "loss_after_steps": float(m["loss"]),
            "train_steps": steps})
    if rank == 0:
        with open(out, "w") as f:
            json.dump(rows, f)


def bench(steps: int, policies: list[str], paths: list[str], *, world_size: int = 8,
          backend: str = "gloo", device: str = "cuda") -> dict:
    from ..dist import world

    unknown = set(paths) - {"dp", "fsdp"}
    if unknown:
        raise ValueError(f"unknown paths {sorted(unknown)}; expected dp and/or fsdp")
    if steps < 2:
        raise ValueError("--steps must be at least 2: the first step is not timed")
    with tempfile.TemporaryDirectory(prefix="dist_bench_") as d:
        out = os.path.join(d, "rows.json")
        world.spawn(_rank, world_size, backend, steps, policies, paths, device, out)
        with open(out) as f:
            rows = json.load(f)
    return {"arch": "dlrm-criteo(reduced)", "batch": BATCH, "devices": world_size,
            "backend": backend, "device": device, "rows": rows}


def check(report: dict) -> list[tuple[str, str]]:
    """(name, message) per failed acceptance check; empty = all green."""
    failures = []
    by = {(r["path"], r["policy"]): r for r in report["rows"]}
    for r in report["rows"]:
        rec = r["recorded_wire_bytes"]
        if rec <= 0:
            failures.append((f"{r['path']}/{r['policy']}", "no collective bytes recorded"))
            continue
        rel = abs(r["wire_bytes"] - rec) / rec
        if rel > HLO_MATCH_TOL:
            failures.append((f"{r['path']}/{r['policy']}",
                             f"accounting {r['wire_bytes']:.0f} vs recorded {rec:.0f} "
                             f"differs {rel:.1%} > {HLO_MATCH_TOL:.0%}"))
    if ("dp", "int8") in by and ("dp", "none") in by:
        ratio = by[("dp", "int8")]["recorded_wire_bytes"] / by[("dp", "none")]["recorded_wire_bytes"]
        report["int8_vs_none_ratio"] = ratio
        if ratio >= INT8_RATIO_BAR:
            failures.append(("dp/int8", f"wire ratio {ratio:.3f} >= {INT8_RATIO_BAR}"))
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30, help="training steps per policy")
    ap.add_argument("--policies", default="none,bf16,int8,auto")
    ap.add_argument("--paths", default="dp,fsdp")
    ap.add_argument("--world", type=int, default=8, help="processes in the world")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--backend", default=None,
                    help="nccl or gloo (default: nccl on cuda, gloo on cpu)")
    ap.add_argument("--out", default=os.path.join(ART, "BENCH_dist.json"))
    args = ap.parse_args(argv)
    backend = args.backend or ("nccl" if args.device == "cuda" else "gloo")

    print("name,us_per_call,derived")
    try:
        report = bench(args.steps, args.policies.split(","), args.paths.split(","),
                       world_size=args.world, backend=backend, device=args.device)
    except Exception as e:  # noqa: BLE001 — reported as an ERROR row, exit 1
        print(f"dist_bench/ERROR,0,{repr(e)[:160]}")
        return 1
    for r in report["rows"]:
        print(f"dist/{r['path']}/{r['policy']},{r['step_time_us']},"
              f"wire_bytes={r['wire_bytes']:.0f};recorded={r['recorded_wire_bytes']:.0f};"
              f"loss={r['loss_after_steps']:.4f}")
    failures = check(report)
    report["checks_failed"] = [f"{n}: {m}" for n, m in failures]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1, default=float)
    for name, msg in failures:
        print(f"dist/check/{name}/ERROR,0,{msg}")
    if failures:
        print(f"# {len(failures)} dist_bench check(s) failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

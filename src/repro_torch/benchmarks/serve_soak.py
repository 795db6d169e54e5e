"""Serving soak of the port: a sustained Zipfian stream through the
device-cache engine, with a hard wall-clock guard and a committed p99
baseline.

Where ``serve_bench`` measures lanes on a short fixed request set, the
soak answers the operational questions: does the continuous-batching
engine survive minutes of open-ended traffic without latency drift,
queue buildup, memory creep (slabs are preallocated — resident bytes
must go flat once the hot set is cached), or a hang?

Protocol (the reference's):

1. build the int8 DLRM engine (``serve_bench``'s reduced config at D=64,
   the kernels on) + an 8192-row ``DeviceHotRowCache``, continuous
   batching;
2. warm until the hit rate saturates (excluded from stats);
3. stream Zipfian requests for ``--duration`` seconds (default 30, env
   ``REPRO_SOAK_DURATION``), reaping continuously and recording per-wave
   latencies;
4. a ``SIGALRM`` fires at ``4 x duration`` — if the engine hangs, the run
   dies with an ``/ERROR`` row and exit 1;
5. p99 is gated against the port's baseline,
   ``src/repro_torch/benchmarks/baselines/serve_soak.json`` (written on the
   card with ``--update-baseline``, with the card's name and power limit):
   regress past ``P99_REGRESSION_X`` and the run fails.  A baseline taken
   on another kind of device is shown, not gated.

Artifacts: ``artifacts/bench/BENCH_serve_soak_torch.json``, the
per-second timeseries ``artifacts/bench/serve_soak_timeseries_torch.csv``,
and CSV rows on stdout (``name,us_per_call,derived``; failures print
``/ERROR`` rows and exit 1).

Usage::

    python -m repro_torch.benchmarks.serve_soak --duration 30 [--update-baseline]
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

ART = "artifacts/bench"
BASELINE = os.path.join(os.path.dirname(__file__), "baselines", "serve_soak.json")
TIMESERIES = os.path.join(ART, "serve_soak_timeseries_torch.csv")
P99_REGRESSION_X = 4.0   # fail if p99 exceeds baseline by this factor
HARD_TIMEOUT_X = 4       # SIGALRM at duration * this (hang guard)
CHUNK = 64               # requests submitted per pump
CACHE_ROWS = 8192


class SoakHang(RuntimeError):
    pass


def _alarm(signum, frame):
    raise SoakHang("hard wall-clock timeout — engine hung?")


def _timeseries(samples: list[dict], lat: list[float]) -> list[dict]:
    """Fold per-pump snapshots into per-second rows (p99, QPS, hit rate,
    resident cache bytes), which place a regression in time."""
    import numpy as np
    rows, prev = [], {"t": 0.0, "waves": 0, "served": 0, "hits": 0, "lookups": 0}
    by_sec: dict[int, dict] = {}
    for s in samples:
        by_sec[int(s["t"])] = s  # last pump snapshot in each second wins
    for sec in sorted(by_sec):
        s = by_sec[sec]
        window = lat[prev["waves"]:s["waves"]]
        dt = s["t"] - prev["t"]
        dlook = s["lookups"] - prev["lookups"]
        rows.append({
            "t_s": sec + 1,
            "p99_ms": float(np.percentile(window, 99)) * 1e3 if window else 0.0,
            "qps": (s["served"] - prev["served"]) / dt if dt > 0 else 0.0,
            "hit_rate": (s["hits"] - prev["hits"]) / dlook if dlook > 0 else 0.0,
            "bytes_cached": s["bytes"],
        })
        prev = s
    return rows


def soak(duration_s: float, max_batch: int = 32, device="cuda") -> dict:
    import torch

    from ..serve.cache import DeviceHotRowCache
    from ..serve.quantize import quantize_params
    from ..serve.recsys import RecsysEngine
    from .serve_bench import _build, _requests, _serve_cfg
    from .timing import card

    device = torch.device(device)
    cfg, _, spec, params = _build("dlrm-criteo", device)
    qparams = quantize_params(params, mode="int8")
    eng = RecsysEngine(_serve_cfg(cfg), qparams, max_batch=max_batch,
                       cache=DeviceHotRowCache(capacity_rows=CACHE_ROWS, device=device),
                       batching="continuous", device=device)

    def stream(seed):
        return _requests(cfg, spec, CHUNK, device, seed=seed, dense_step=101 + seed)

    # warm: the hot-pool seeds (the catalog steady-state traffic draws from,
    # resident after this) plus two fresh-seed chunks, so the mixed hit/miss
    # shapes have run before the clock starts
    for warm_seed in (1, 2, 3, 4, 1, 10_001, 10_002):
        for d, b in stream(warm_seed):
            eng.submit(d, b)
        eng.run_until_drained()
    eng.reset_metrics()   # resident bytes survive; traffic counters restart

    # arm the hang guard only now: build and warm-up may be slow
    if hasattr(signal, "SIGALRM"):
        signal.alarm(int(duration_s * HARD_TIMEOUT_X) + 10)

    # steady-state traffic: Zipf draws over the warmed hot pool (seeds cycle,
    # so the catalog is finite), with a fresh chunk every 8th pump so cold
    # rows keep flowing through the miss/admission path
    bytes_samples, pump_samples = [], []
    t0 = time.monotonic()
    pump, served = 0, 0
    while time.monotonic() - t0 < duration_s:
        seed = 20_000 + pump if pump % 8 == 7 else 1 + pump % 4
        for d, b in stream(seed):
            eng.submit(d, b)
        pump += 1
        while eng._queue or eng._inflight:
            served += len(eng.step())
        stats = eng.cache.stats
        bytes_samples.append(stats.bytes_cached)
        pump_samples.append({"t": time.monotonic() - t0, "waves": len(eng.wave_latencies_s),
                             "served": served, "hits": stats.hits,
                             "lookups": stats.lookups, "bytes": stats.bytes_cached})
    wall = time.monotonic() - t0

    m = eng.metrics()
    # memory-creep guard: the Zipf tail trickles admissions forever, but the
    # rate must decelerate and residency must respect the slab capacity
    mid = len(bytes_samples) // 2
    first = bytes_samples[mid] - bytes_samples[0] if mid else 0
    last = bytes_samples[-1] - bytes_samples[mid] if mid else 0
    cap_bytes = CACHE_ROWS * cfg.emb_dim * 4
    return {
        "duration_s": wall, "served": served, "qps": m["qps"],
        "p50_ms": m["p50_ms"], "p99_ms": m["p99_ms"], "waves": m["waves"],
        "hit_rate": m["cache"]["hit_rate"], "cache_paths": m["cache_paths"],
        "bytes_cached": eng.cache.stats.bytes_cached,
        "bytes_growth_first_half": first, "bytes_growth_last_half": last,
        "bytes_ok": last <= max(first, 4096) and eng.cache.stats.bytes_cached <= cap_bytes,
        "max_batch": max_batch, "batching": "continuous", "mode": "int8",
        "device": device.type, "card": card() if device.type == "cuda" else None,
        "timeseries": _timeseries(pump_samples, eng.wave_latencies_s),
    }


def gated(report: dict, baseline: dict | None) -> bool:
    """Whether ``baseline`` was taken on the run's kind of device."""
    return baseline is not None and baseline.get("device") == report["device"]


def check(report: dict, baseline: dict | None) -> list[tuple[str, str]]:
    failures = []
    if report["served"] < 1:
        failures.append(("served", "soak served zero requests"))
    if not report.get("timeseries"):
        failures.append(("timeseries", "soak produced no per-second timeseries rows"))
    if not (report["hit_rate"] or 0) > 0.5:
        failures.append(("hit_rate", f"hit rate {report['hit_rate']} "
                                     "never saturated under Zipf traffic"))
    if not report["bytes_ok"]:
        failures.append(
            ("bytes", f"cache residency creep: growth accelerated "
                      f"({report['bytes_growth_first_half']} B first half "
                      f"-> {report['bytes_growth_last_half']} B last half) "
                      f"or capacity exceeded"))
    if gated(report, baseline):
        bar = baseline["p99_ms"] * P99_REGRESSION_X
        if report["p99_ms"] > bar:
            failures.append(("p99", f"p99 {report['p99_ms']:.2f} ms exceeds "
                                    f"{P99_REGRESSION_X}x baseline "
                                    f"({baseline['p99_ms']:.2f} ms)"))
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float,
                    default=float(os.environ.get("REPRO_SOAK_DURATION", 30)))
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--update-baseline", action="store_true")
    ap.add_argument("--baseline", default=BASELINE, help="the p99 baseline to gate on")
    ap.add_argument("--out", default=os.path.join(ART, "BENCH_serve_soak_torch.json"))
    ap.add_argument("--timeseries-out", default=TIMESERIES,
                    help="per-second timeseries CSV (t_s,p99_ms,qps,hit_rate,bytes_cached)")
    args = ap.parse_args(argv)

    print("name,us_per_call,derived")
    if hasattr(signal, "SIGALRM"):
        signal.signal(signal.SIGALRM, _alarm)  # armed inside soak()
    try:
        report = soak(args.duration, args.max_batch, args.device)
    except Exception as e:
        print(f"serve_soak/ERROR,0,{repr(e)[:160]}")
        return 1
    finally:
        if hasattr(signal, "SIGALRM"):
            signal.alarm(0)

    baseline = None
    if os.path.exists(args.baseline):
        with open(args.baseline) as f:
            baseline = json.load(f)
    failures = check(report, baseline)
    report["checks_failed"] = [f"{n}: {m}" for n, m in failures]
    report["baseline"] = baseline

    for path in (args.out, args.timeseries_out):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1, default=float)
    with open(args.timeseries_out, "w") as f:
        f.write("t_s,p99_ms,qps,hit_rate,bytes_cached\n")
        for r in report["timeseries"]:
            f.write(f"{r['t_s']},{r['p99_ms']:.3f},{r['qps']:.1f},"
                    f"{r['hit_rate']:.4f},{r['bytes_cached']}\n")
    if args.update_baseline and not failures:
        os.makedirs(os.path.dirname(args.baseline), exist_ok=True)
        with open(args.baseline, "w") as f:
            json.dump({k: report[k] for k in ("p99_ms", "p50_ms", "qps", "duration_s",
                                              "max_batch", "device", "card")}, f, indent=1)
            f.write("\n")

    print(f"serve_soak/int8/cache_on/continuous,{report['p50_ms'] * 1e3:.0f},"
          f"qps={report['qps']:.1f};p99_ms={report['p99_ms']:.2f};"
          f"served={report['served']};hit_rate={report['hit_rate']:.3f};"
          f"wall_s={report['duration_s']:.2f}")
    if report["card"]:
        print(f"# card: {report['card']}")
    if baseline is not None and not gated(report, baseline):
        print(f"# baseline taken on {baseline.get('card') or baseline.get('device')}: "
              f"p99 not gated on {report['device']}")
    for name, msg in failures:
        print(f"serve_soak/check/{name}/ERROR,0,{msg}")
    if failures:
        print(f"# {len(failures)} serve_soak check(s) failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

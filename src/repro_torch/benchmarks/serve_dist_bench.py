"""Sharded-serving benchmark: plan-aware placement over a world of ranks,
as the JAX package's ``benchmarks/serve_dist_bench.py``.

Runs the paper's DLRM (reduced Criteo config, deployment D=64) from a
solved mixed-dimension memory plan, int8-quantized, through the sharded
``RecsysEngine`` (``dist.serve_placement``: replicate small sub-tables,
row-shard big ones, fetch remote rows over the two-phase all-to-all
exchange) in a world of ``--world`` processes, and reports the
reference's four acceptance rows (``/ERROR`` + exit 1 on a failed
check):

* **placement** — per-rank table bytes under the placement stay within
  the plan's even share plus the replication overhead:
  ``bytes/rank <= plan_total/N + replicated + row-pad``; and the
  placement annotation round-trips through the plan JSON;
* **wire** — the exchange bytes ``dist.wire`` **recorded** for one
  sharded embed wave (every tensor the exchange handed to an all-to-all)
  equal ``dist.accounting.serve_wave_wire_bytes`` **exactly**: the
  recorded bytes stand where the reference's HLO analyzer's stood;
* **parity** — the sharded engine's scores are **bit-identical** to a
  single-device engine serving the same stream at the per-rank batch
  (cache off and cache on), with empty bags in the stream; the cache lane
  must also see a positive hit rate;
* **qps** — the single-device and the sharded engines' throughput, and
  the sharded one projected per host (× N: the N ranks share one host or
  one card here).  A reported projection, never a gate.

Rank 0 reports.  ``--device cpu`` runs the world on the host (gloo);
``--device cuda`` puts rank ``r`` on card ``r mod count`` (NCCL with a
card per rank, else gloo with every rank's tensors on its card).

Artifacts: ``artifacts/bench_torch/BENCH_serve_dist.json`` + CSV on
stdout (``name,us_per_call,derived``).

Usage::

    python -m repro_torch.benchmarks.serve_dist_bench --device cpu --world 8 --requests 512
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

ART = "artifacts/bench_torch"
SERVE_EMB_DIM = 64
PLAN_BUDGET = 1 << 20          # serve-int8 domain bytes for the plan
MAX_BATCH = 256                # global; the per-rank bucket is MAX_BATCH / world
MAX_BAG = 8
CACHE_ROWS = 1 << 15

__all__ = ["bench", "check", "main"]


def _requests(cfg, n: int, max_bag: int = MAX_BAG):
    """The reference's deterministic Zipfian multi-hot stream with empty
    bags (every 4th request drops one feature's bag) and the bag-length
    bucket pinned: every 32-request block carries a ``max_bag`` bag."""
    import numpy as np
    f = len(cfg.table_sizes)
    rng = np.random.default_rng(1234)
    out = []
    for r in range(n):
        length = max_bag if r % 32 == 0 else 1 + (r * 7) % max_bag
        dense = rng.normal(size=(13,)).astype(np.float32)
        bags = [list(((rng.zipf(1.5, size=length) - 1) % s).astype(int))
                for s in cfg.table_sizes]
        if r % 4 == 1:
            bags[r % f] = []   # legal empty bag -> exact zero-vector pool
        out.append((dense, bags))
    return out


def _plan():
    from ..configs import dlrm_criteo as mod
    from ..plan import plan_for_config
    base = dataclasses.replace(mod.config(reduced=True), emb_dim=SERVE_EMB_DIM)
    return plan_for_config(base, PLAN_BUDGET, arch="dlrm-criteo", bytes_domain="serve_int8",
                           dims=(SERVE_EMB_DIM // 4, SERVE_EMB_DIM // 2, SERVE_EMB_DIM))


def _scores(engine, reqs):
    import numpy as np
    uids = [engine.submit(d, b) for d, b in reqs]
    done = engine.run_until_drained()
    return np.asarray([done[u].score for u in uids], np.float32)


def _qps(engine, reqs, reps: int) -> float:
    best = 0.0
    for _ in range(reps + 1):          # the first rep warms every bucket
        engine.reset_metrics()
        _scores(engine, reqs)
        best = max(best, engine.metrics()["qps"])
    return best


def _rank(rank, world, plan_path, requests, reps, device_type, out):
    """One rank: every row; rank 0 writes the report to ``out``."""
    import numpy as np
    import torch

    from ..configs import dlrm_criteo as mod
    from ..dist import wire
    from ..dist.accounting import serve_wave_wire_bytes
    from ..dist.serve_placement import plan_placement
    from ..plan import MemoryPlan
    from ..serve.cache import DeviceHotRowCache
    from ..serve.quantize import memory_report, quantize_params
    from ..serve.recsys import RecsysEngine

    if device_type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    plan = MemoryPlan.load(plan_path)
    cfg = mod.config(reduced=True, plan=plan)
    params = mod.api(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    qparams = quantize_params(params, mode="int8")
    reqs = _requests(cfg, requests)

    placement = plan_placement(qparams, world, plan=plan)
    rep = memory_report(params, qparams, placement=placement)
    placement_row = None
    if rank == 0:
        plan.annotate_placement(placement)
        with tempfile.TemporaryDirectory(prefix="serve_dist_plan_") as d:
            rt = MemoryPlan.load(plan.save(os.path.join(d, "plan.json"))).serve_placement()
        placement_row = {
            **placement.summary(), "plan_total_bytes": plan.total_bytes,
            "bound_bytes": (plan.total_bytes // world + placement.replicated_bytes()
                            + placement.pad_bytes()),
            "table_bytes_per_device": rep["placement"]["table_bytes_per_device"],
            "roundtrip_ok": rt is not None and rt.as_dict() == placement.as_dict()}

    t0 = time.monotonic()
    kw = {"batching": "waves", "device": device}
    eng_n = RecsysEngine(cfg, qparams, max_batch=MAX_BATCH, mesh_devices=world,
                         placement=placement, **kw)
    eng_c = RecsysEngine(cfg, qparams, max_batch=MAX_BATCH, mesh_devices=world,
                         placement=placement,
                         cache=DeviceHotRowCache(CACHE_ROWS, device=device), **kw)

    # wire: the exchange bytes of one sharded embed wave, recorded vs accounted
    bb, lb, f = MAX_BATCH, MAX_BAG, len(cfg.table_sizes)
    idx = np.zeros((bb, f, lb), np.int32)
    mask = np.zeros((bb, f, lb), np.float32)
    wire.reset()
    with torch.inference_mode():
        eng_n._embed_fwd(eng_n._local(idx), eng_n._local(mask))
    snap = wire.snapshot()
    recorded = sum(b for leaf, b in snap["per_leaf"].items() if leaf.startswith("tables/"))
    acct = serve_wave_wire_bytes(placement, bb // world, lb)
    wire_row = {"wire_bytes": acct["total_bytes"], "recorded_wire_bytes": recorded,
                "recorded_collectives": {k: v["calls"] for k, v in snap["per_kind"].items()},
                "lookups_per_device": acct["lookups_per_device"],
                "sharded_sub_tables": len(placement.sharded)}

    # parity: bit-identical scores, cache off and on
    eng_1 = RecsysEngine(cfg, qparams, max_batch=MAX_BATCH // world, **kw) if rank == 0 \
        else None
    s1 = _scores(eng_1, reqs) if rank == 0 else None
    sn = _scores(eng_n, reqs)
    _scores(eng_c, reqs)               # the warm pass fills the cache
    sc = _scores(eng_c, reqs)
    hit_rate = eng_c.metrics()["cache"]["hit_rate"]
    setup_s = time.monotonic() - t0

    # throughput: raw + per-host projection
    qps1 = _qps(RecsysEngine(cfg, qparams, max_batch=MAX_BATCH, device=device), reqs, reps) \
        if rank == 0 else None
    qpsn = _qps(RecsysEngine(cfg, qparams, max_batch=MAX_BATCH, mesh_devices=world,
                             placement=placement, device=device), reqs, reps)
    if rank != 0:
        return
    report = {
        "arch": "dlrm-criteo(reduced,plan)", "devices": world, "device": device_type,
        "max_batch": MAX_BATCH, "max_bag": MAX_BAG, "setup_s": round(setup_s, 2),
        "placement": placement_row, "wire": wire_row,
        "parity": {"bitwise": bool(np.array_equal(s1, sn)),
                   "bitwise_cache": bool(np.array_equal(s1, sc)),
                   "maxdiff": float(np.abs(s1 - sn).max()),
                   "maxdiff_cache": float(np.abs(s1 - sc).max()),
                   "cache_hit_rate": float(hit_rate), "requests": requests},
        "qps": {"qps_1dev": qps1, f"qps_{world}dev_raw": qpsn,
                f"qps_{world}dev_projected": qpsn * world, "projection_factor": world,
                "gated": False}}
    with open(out, "w") as fh:
        json.dump(report, fh)


def bench(requests: int, reps: int, *, world_size: int = 8, device: str = "cuda",
          backend: str | None = None) -> dict:
    import torch

    from ..dist import world
    backend = backend or ("nccl" if device == "cuda"
                          and world_size <= torch.cuda.device_count() else "gloo")
    with tempfile.TemporaryDirectory(prefix="serve_dist_bench_") as d:
        plan_path = _plan().save(os.path.join(d, "plan.json"))
        out = os.path.join(d, "report.json")
        world.spawn(_rank, world_size, backend, plan_path, requests, reps, device, out)
        with open(out) as fh:
            report = json.load(fh)
    report["backend"] = backend
    return report


def check(report: dict) -> list[tuple[str, str]]:
    """(name, message) per failed acceptance check; empty = all green."""
    failures = []
    p = report["placement"]
    if p["table_bytes_per_device"] > p["bound_bytes"]:
        failures.append(("placement", f"{p['table_bytes_per_device']} B/device exceeds "
                                      f"plan_total/N + replication = {p['bound_bytes']}"))
    if not p["roundtrip_ok"]:
        failures.append(("placement", "placement annotation did not round-trip through "
                                      "the plan JSON"))
    w = report["wire"]
    if w["sharded_sub_tables"] == 0:
        failures.append(("wire", "placement sharded nothing — the exchange path was never "
                                 "exercised"))
    if w["wire_bytes"] != w["recorded_wire_bytes"]:
        failures.append(("wire", f"accounted {w['wire_bytes']:.0f} != recorded "
                                 f"{w['recorded_wire_bytes']:.0f} (exact match required)"))
    par = report["parity"]
    if not par["bitwise"]:
        failures.append(("parity", f"sharded scores differ from single-device by "
                                   f"{par['maxdiff']:.3e}"))
    if not par["bitwise_cache"]:
        failures.append(("parity", f"cache-on sharded scores differ by "
                                   f"{par['maxdiff_cache']:.3e}"))
    if not par["cache_hit_rate"] > 0:
        failures.append(("parity", "sharded device cache saw no hits"))
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=512)
    ap.add_argument("--reps", type=int, default=2, help="timed reps per QPS lane (best-of, "
                                                        "after a warm one)")
    ap.add_argument("--world", type=int, default=8, help="processes (ranks) in the world")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--backend", default=None, help="nccl or gloo (default: nccl with a card "
                                                    "per rank, else gloo)")
    ap.add_argument("--out", default=os.path.join(ART, "BENCH_serve_dist.json"))
    args = ap.parse_args(argv)

    print("name,us_per_call,derived")
    try:
        report = bench(args.requests, args.reps, world_size=args.world, device=args.device,
                       backend=args.backend)
    except Exception as e:  # noqa: BLE001 — reported as an ERROR row, exit 1
        print(f"serve_dist_bench/ERROR,0,{repr(e)[:160]}")
        return 1
    p, w, par, q = report["placement"], report["wire"], report["parity"], report["qps"]
    n = report["devices"]
    print(f"serve_dist/placement,0,bytes_per_device={p['table_bytes_per_device']};"
          f"bound={p['bound_bytes']};sharded={p['row_sharded']};replicated={p['replicated']}")
    print(f"serve_dist/wire,0,acct={w['wire_bytes']:.0f};recorded={w['recorded_wire_bytes']:.0f}")
    print(f"serve_dist/parity,0,bitwise={int(par['bitwise'])};"
          f"bitwise_cache={int(par['bitwise_cache'])};hit_rate={par['cache_hit_rate']:.3f}")
    print(f"serve_dist/qps,0,qps1={q['qps_1dev']:.1f};qps{n}_raw={q[f'qps_{n}dev_raw']:.1f};"
          f"qps{n}_proj={q[f'qps_{n}dev_projected']:.1f}")
    failures = check(report)
    report["checks_failed"] = [f"{name}: {msg}" for name, msg in failures]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1, default=float)
    for name, msg in failures:
        print(f"serve_dist/check/{name}/ERROR,0,{msg}")
    if failures:
        print(f"# {len(failures)} serve_dist_bench check(s) failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

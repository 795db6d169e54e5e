#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero, and no result line is printed):

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the serving path from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, started together) and print the compiler's
   register / shared-memory report;
3. hold the fused serving kernel (K4, ``fused_serve_pool``) against its
   plain PyTorch version on the card at the serving shapes (int8 QR pair,
   B=256, L=4, D=16) and over its variants: f32, bf16, add, a single
   table, a projection, empty bags and an all-empty (L=0) wave;
4. hold the interaction kernel (K2, ``dot_interaction``) against its plain
   version at B=256, F=27, D=16 in f32 and bf16;
5. serve the full-width DLRM-Criteo (26 Kaggle tables, QR with 4
   collisions, D=16, int8 tables) through ``RecsysEngine`` over launcher-
   style requests with some empty bags; check that every request is scored
   and finite, that the kernels' launch counts match the waves, and that a
   sample of scores matches the same engine with ``use_kernel=False``;
   print p50/p99/QPS, peak memory and table bytes;
6. time each kernel, its plain version and a PyTorch yardstick with CUDA
   events, compute each kernel's bound from this run's inputs, and print
   the ``kernels`` JSON line.

The last line is ``{"ok": true, "device": {...}}``.  Imports nothing of
JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 rate, and f32 outside
# the tensor cores — both kernels do f32 FMAs on CUDA cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# Tolerances, kernel vs plain version on the same card inputs:
#   f32 / int8 outputs: 1e-5 — both sum in f32, in another order (the
#   plain version's reductions, the kernel's sequential l loop and FMAs);
#   bf16 outputs: 3e-2 — the single final rounding to bf16 can land one
#   bf16 step apart when the f32 sums differ in their last bit.
TOL = {"f32": 1e-5, "int8": 1e-5, "bf16": 3e-2}
# engine scores, kernels vs plain path: f32 summation order through the
# pooling, the interaction and two MLPs
SCORE_TOL = 1e-4

B, L, D, F = 256, 4, 16, 27


def _fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _time_ms(torch, fn, iters: int) -> float:
    """Device time of one ``fn()`` call: CUDA events around ``iters`` calls
    queued behind a sleep kernel, so the host's launch cost stays off the
    device's clock."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s at H100 clocks: the host queues ahead
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _short_name(kernel: str) -> str:
    """A readable name for a device event: the PyTorch functor or kernel
    template it runs, else its first identifier followed by ``<`` or ``(``,
    else its first 60 characters."""
    name = kernel.replace("(anonymous namespace)", "")
    for pat in (r"\w+_kernel_cuda", r"\w*Functor_?\w*", r"Memcpy \w+",
                r"\w+_kernel<[^>(]*>", r"\w+(?=<|\()"):
        m = re.search(pat, name)
        if m:
            return m.group(0)[:60]
    return name[:60]


def _max_err(torch, got, want) -> float:
    return float((got.float() - want.float()).abs().max()) if got.numel() else 0.0


def _zipf_ids(torch, gen, shape, size):
    u = torch.rand(shape, generator=gen, device="cuda")
    return torch.clamp(torch.floor(u ** 1.5 * size), max=size - 1).to(torch.int32)


def check_serve_pool(torch, gen):
    """K4 against its plain version; returns (max abs error, timing inputs)."""
    from repro_torch.kernels import ref, serve_path
    from repro_torch.serve.quantize import quantize_table

    size = 10131227                 # the largest Kaggle table, QR c=4
    m = -(-size // 4)
    q_rows = -(-size // m)
    w_rem = torch.randn((m, D), generator=gen, device="cuda") * 0.05
    w_quo = torch.randn((q_rows, D), generator=gen, device="cuda") * 0.05
    qa, qb = quantize_table(w_rem), quantize_table(w_quo)
    ids = _zipf_ids(torch, gen, (B, L), size)
    mask = (torch.rand((B, L), generator=gen, device="cuda") > 0.2).float()
    mask[B - 8:] = 0.0                                   # empty bags
    rem, quo = ids % m, ids // m
    proj = torch.randn((D, D), generator=gen, device="cuda") * 0.25
    narrow = torch.randn((D // 2, D), generator=gen, device="cuda") * 0.25
    cases = {
        "int8 pair": ("int8", (rem, mask, qa["q"], quo, qb["q"], qa["scale"], qa["zp"],
                               qb["scale"], qb["zp"]), {}),
        "int8 pair add": ("int8", (rem, mask, qa["q"], quo, qb["q"], qa["scale"],
                                   qa["zp"], qb["scale"], qb["zp"]), {"op": "add"}),
        "int8 pair + proj": ("int8", (rem, mask, qa["q"], quo, qb["q"], qa["scale"],
                                      qa["zp"], qb["scale"], qb["zp"], proj), {}),
        "f32 pair": ("f32", (rem, mask, w_rem, quo, w_quo), {}),
        "bf16 pair": ("bf16", (rem, mask, w_rem.bfloat16(), quo, w_quo.bfloat16()), {}),
        "bf16 pair + proj": ("bf16", (rem, mask, w_rem.bfloat16(), quo, w_quo.bfloat16(),
                                     None, None, None, None, proj), {}),
        "f32 single": ("f32", (rem, mask, w_rem), {}),
        "f32 single d=8 + proj": ("f32", (rem, mask, w_rem[:, :D // 2].contiguous(), None,
                                          None, None, None, None, None, narrow), {}),
        "int8 pair L=0": ("int8", (rem[:, :0], mask[:, :0], qa["q"], quo[:, :0], qb["q"],
                                   qa["scale"], qa["zp"], qb["scale"], qb["zp"]), {}),
    }
    worst = 0.0
    for name, (kind, args, kw) in cases.items():
        got = serve_path.fused_serve_pool(*args, **kw)
        want = ref.fused_serve_pool(*args, **kw)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            _fail(f"K4 {name}: {tuple(got.shape)} {got.dtype} vs plain "
                  f"{tuple(want.shape)} {want.dtype}")
        err = _max_err(torch, got, want)
        tol = TOL[kind] * (1.0 + float(want.float().abs().max()))
        empty_ok = bool((got[B - 8:] == 0).all())
        print(f"  K4 {name:24s} max|err| {err:.3e} (tol {tol:.1e}) empty bags zero: {empty_ok}")
        if not err <= tol or not empty_ok or not torch.isfinite(got.float()).all():
            _fail(f"K4 {name} disagrees with its plain version")
        worst = max(worst, err)
    return worst, (rem, quo, mask, qa, qb, w_rem)


def check_interaction(torch, gen):
    from repro_torch.kernels import dot_interaction, ref

    x = torch.randn((B, F, D), generator=gen, device="cuda")
    worst = 0.0
    for kind, xi in (("f32", x), ("bf16", x.bfloat16())):
        got = dot_interaction.dot_interaction(xi)
        want = ref.dot_interaction(xi)
        torch.cuda.synchronize()
        err = _max_err(torch, got, want)
        tol = TOL[kind] * (1.0 + float(want.float().abs().max()))
        print(f"  K2 {kind:5s} {tuple(got.shape)} max|err| {err:.3e} (tol {tol:.1e})")
        if got.shape != (B, F * (F - 1) // 2) or got.dtype != xi.dtype or not err <= tol:
            _fail(f"K2 {kind} disagrees with its plain version")
        worst = max(worst, err)
    return worst, x


def serve_full_width(torch):
    """Serve the full-width int8 DLRM-Criteo; returns the main path's launch
    counts, the engine and its requests."""
    import numpy as np

    from repro_torch.configs import dlrm_criteo
    from repro_torch.kernels import dot_interaction, serve_path
    from repro_torch.launch.serve import request_stream
    from repro_torch.models.dlrm import dlrm_init
    from repro_torch.serve.quantize import memory_report, quantize_params
    from repro_torch.serve.recsys import RecsysEngine

    cfg = dataclasses.replace(dlrm_criteo.config(reduced=False), use_kernel=True)
    t = time.perf_counter()
    params = dlrm_init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    qparams = quantize_params(params, mode="int8")
    rep = memory_report(params, qparams)
    del params
    torch.cuda.synchronize()
    print(f"  init + quantize on the card: {time.perf_counter() - t:.2f} s; tables "
          f"{rep['f32_table_bytes']} B f32 -> {rep['quant_table_bytes']} B int8 "
          f"({rep['ratio']:.4f}x)")

    rng = np.random.default_rng(0)
    reqs = list(request_stream(rng, cfg.table_sizes, cfg.dense_dim, 2304, 4))
    for k, (_, bags) in enumerate(reqs):               # some empty bags
        for i in np.flatnonzero(rng.random(len(bags)) < 0.1):
            bags[i] = []
        if k % 500 == 7:
            reqs[k] = (reqs[k][0], [[] for _ in bags])  # a request with no ids at all
    warm, main = reqs[:256], reqs[256:]

    engine = RecsysEngine(cfg, qparams, max_batch=256, batching="continuous")
    for dense, bags in warm:
        engine.submit(dense, bags)
    engine.run_until_drained()
    engine.reset_metrics()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    serve_path.fused_serve_pool.launches = 0
    dot_interaction.dot_interaction.launches = 0
    uids = [engine.submit(dense, bags) for dense, bags in main]
    done = engine.run_until_drained()
    counts = {"fused_serve_pool": serve_path.fused_serve_pool.launches,
              "dot_interaction": dot_interaction.dot_interaction.launches}
    m = engine.metrics()
    peak = torch.cuda.max_memory_allocated()

    scores = np.array([done[u].score for u in uids], dtype=np.float64)
    if len(scores) != len(main) or not np.isfinite(scores).all():
        _fail("not every request was scored with a finite value")
    waves, n_tables = m["waves"], len(cfg.table_sizes)
    print(f"  served {m['requests']} requests in {waves} waves | p50 {m['p50_ms']:.3f} ms "
          f"p99 {m['p99_ms']:.3f} ms qps {m['qps']:.1f} | peak memory {peak} B | "
          f"buckets {m['buckets']}")
    print(f"  launches: fused_serve_pool {counts['fused_serve_pool']} "
          f"(26 x {waves} waves = {n_tables * waves}), dot_interaction "
          f"{counts['dot_interaction']} ({waves} waves)")
    if counts["fused_serve_pool"] != n_tables * waves or counts["dot_interaction"] != waves:
        _fail("the main path did not go through the kernels once per table and wave")

    plain_cfg = dataclasses.replace(cfg, use_kernel=False)
    plain = RecsysEngine(plain_cfg, qparams, max_batch=256, batching="continuous")
    sample = list(range(0, len(main), 7))
    for k in sample:
        plain.submit(*main[k])
    pdone = plain.run_until_drained()
    diff = max(abs(pdone[j].score - scores[k]) for j, k in enumerate(sample))
    print(f"  kernels vs plain engine on {len(sample)} requests: max |score diff| "
          f"{diff:.3e} (tol {SCORE_TOL:.0e})")
    if not diff <= SCORE_TOL:
        _fail("kernel engine scores disagree with the plain engine")
    return counts, engine, main


def profile_waves(torch, engine, reqs):
    """Where a full wave's time goes: wall time per wave (no profiler),
    device time per wave (``torch.profiler``, every kernel and copy), and
    the host's time to pad one wave."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.recsys import RecRequest

    def drain():
        engine.reset_metrics()
        for dense, bags in reqs:
            engine.submit(dense, bags)
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine.run_until_drained()
        torch.cuda.synchronize()
        return time.perf_counter() - t, engine.metrics()["waves"]

    wall, waves = drain()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, pwaves = drain()
    # device-side events only (kernels, copies): a CPU op's device time
    # would count its kernels twice
    on_device = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    dev = {}
    for ev in on_device:
        name = _short_name(ev.key)
        dev[name] = dev.get(name, 0.0) + ev.self_device_time_total
    wave = [RecRequest(k, np.asarray(d, np.float32), [list(b) for b in bags])
            for k, (d, bags) in enumerate(reqs[:engine.max_batch])]
    t = time.perf_counter()
    for _ in range(5):
        engine._pad_wave(wave)
    pad_ms = (time.perf_counter() - t) / 5 * 1e3
    out = {"requests": len(reqs), "waves": waves, "wall_ms_per_wave": wall / waves * 1e3,
           "device_ms_per_wave": sum(dev.values()) / pwaves / 1e3,
           "host_pad_ms_per_full_wave": pad_ms,
           "device_ops_per_wave": sum(ev.count for ev in on_device) / pwaves,
           "top_device_ms_per_wave": {k: v / pwaves / 1e3 for k, v in
                                      sorted(dev.items(), key=lambda kv: -kv[1])[:8]}}
    out["device_busy_share"] = out["device_ms_per_wave"] / out["wall_ms_per_wave"]
    print(f"  per wave: wall {out['wall_ms_per_wave']:.3f} ms, device "
          f"{out['device_ms_per_wave']:.3f} ms (busy {out['device_busy_share']:.3f}), "
          f"host pad {pad_ms:.3f} ms")
    print(json.dumps({"wave_profile": out}))


def _k4_bound(rem, quo, mask):
    """Bytes the function must move at these inputs (ids, mask and output
    once; each distinct live row once: D int8 bytes + 2 scale + 1 zp) and
    its f32 operations (2 dequant x 2 tables, combine, weight, add per
    element of a live slot)."""
    live = mask > 0
    rows = int(rem[live].unique().numel()) + int(quo[live].unique().numel())
    nbytes = 3 * rem.numel() * 4 + rows * (D + 3) + rem.shape[0] * D * 4
    ops = int(live.sum()) * D * 7
    return nbytes, ops


def measure(torch, k4_inputs, x, counts, errs):
    import torch.nn.functional as tf

    from repro_torch.kernels import dot_interaction, ref, serve_path

    rem, quo, mask, qa, qb, w_rem = k4_inputs
    k4_args = (rem, mask, qa["q"], quo, qb["q"], qa["scale"], qa["zp"], qb["scale"], qb["zp"])
    k4_ms = _time_ms(torch, lambda: serve_path.fused_serve_pool(*k4_args), 200)
    k4_plain = _time_ms(torch, lambda: ref.fused_serve_pool(*k4_args), 50)
    # yardstick: one dense f32 table, where a single PyTorch call exists
    k4_single = _time_ms(torch, lambda: serve_path.fused_serve_pool(rem, mask, w_rem), 200)
    bag_ms = _time_ms(torch, lambda: tf.embedding_bag(rem, w_rem, mode="sum",
                                                      per_sample_weights=mask), 200)
    k2_ms = _time_ms(torch, lambda: dot_interaction.dot_interaction(x), 200)
    k2_plain = _time_ms(torch, lambda: ref.dot_interaction(x), 50)
    i, j = torch.tril_indices(F, F, offset=-1, device="cuda")
    bmm_ms = _time_ms(torch, lambda: torch.bmm(x, x.transpose(1, 2))[:, i, j], 200)

    k4_bytes, k4_ops = _k4_bound(rem, quo, mask)
    k2_bytes = x.numel() * 4 + B * (F * (F - 1) // 2) * 4
    k2_ops = B * (F * (F - 1) // 2) * 2 * D

    def entry(name, source, replaces, ms, plain_ms, nbytes, ops, extra):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS_PER_S * 1e3
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": counts[name], "max_abs_err": errs[name], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None, **extra}

    return [
        entry("fused_serve_pool", "src/repro_torch/csrc/serve_path.cu",
              "src/repro/kernels/serve_path.py:191", k4_ms, k4_plain, k4_bytes, k4_ops,
              {"shape": f"int8 QR pair B={B} L={L} D={D}",
               "yardstick": "F.embedding_bag(mode='sum', per_sample_weights=) on one "
                            "dense f32 table, beside the kernel on that table",
               "yardstick_ms": bag_ms, "ms_single_f32_table": k4_single}),
        entry("dot_interaction", "src/repro_torch/csrc/dot_interaction.cu",
              "src/repro/kernels/dot_interaction.py:52", k2_ms, k2_plain, k2_bytes, k2_ops,
              {"shape": f"f32 B={B} F={F} D={D}",
               "yardstick": "torch.bmm + triangle index (two calls)",
               "yardstick_ms": bmm_ms}),
    ]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    card = _card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")

    t = time.perf_counter()
    logs = _build.build_all()
    print(f"[build] {len(logs)} kernels in {time.perf_counter() - t:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "error" in line.lower():
                print(f"  {name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    print("[K4] fused_serve_pool vs plain")
    k4_err, k4_inputs = check_serve_pool(torch, gen)
    print("[K2] dot_interaction vs plain")
    k2_err, x = check_interaction(torch, gen)
    print("[serve] full-width DLRM-Criteo, int8 QR tables")
    counts, engine, reqs = serve_full_width(torch)
    print("[profile] where a full wave's time goes")
    profile_waves(torch, engine, reqs[:1024])
    print("[time] CUDA events")
    kernels = measure(torch, k4_inputs, x, counts,
                      {"fused_serve_pool": k4_err, "dot_interaction": k2_err})
    print(f"  card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero, and no result line is printed):

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the port from ``src/repro_torch/csrc`` (four
   sources, one ``nvcc`` each, started together) and print the compiler's
   register / shared-memory report;
3. hold the fused serving kernel (K4, ``fused_serve_pool``) against its
   plain PyTorch version on the card at the serving shapes (int8 QR pair,
   B=256, L=4, D=16) and over its variants: f32, bf16, add, a single
   table, a projection, empty bags and an all-empty (L=0) wave;
4. hold the interaction kernel (K2, ``dot_interaction``) against its plain
   version at B=256, F=27, D=16 in f32 and bf16;
5. hold the one-hot QR lookups against their plain versions on the
   largest Kaggle table (QR c=4: 2,532,807 + 4 rows, D=16) at N=256 Zipf
   ids: K1 ``qr_gather`` in f32 and bf16, mult and add, and a 3-D ``idx``
   through ``ops.qr_lookup``; K5 ``qr_gather_quant`` on the int8 pair;
6. hold the QR embedding bag (K3, ``qr_embedding_bag``) against its plain
   version on that table at B=256, L=4, D=16 (f32 and bf16, fractional
   weights, empty bags), and run the f32-accumulation audit (B=8, L=16,
   D=128, bf16) against an f32 oracle;
7. serve the full-width DLRM-Criteo (26 Kaggle tables, QR with 4
   collisions, D=16, int8 tables) through ``RecsysEngine`` over launcher-
   style requests with some empty bags; check that every request is scored
   and finite, that the kernels' launch counts match the waves, and that a
   sample of scores matches the same engine with ``use_kernel=False``;
   print p50/p99/QPS, peak memory and table bytes; profile a full wave;
8. score 12 held-out batches of 256 (steps 10,000-10,011, the reference's
   ``paper_tables`` evaluation) with the full-width one-hot DLRM-Criteo
   through ``api(cfg).batch_fn`` / ``loss_fn`` / ``predict``, once with
   f32 tables (K1 and K2) and once after int8 quantization (K5 and K2);
   check the launch counts, finite logits, and logits and loss against
   ``use_kernel=False``; print BCE, accuracy, wall and device ms per batch,
   the device's busy share, table bytes and peak memory;
9. drive K3's own entry point ``ops.qr_bag_lookup`` at the shape of the
   reference's kernel bench and on the largest Kaggle table;
10. time each kernel, its plain version and a PyTorch yardstick with CUDA
   events, compute each kernel's bound from this run's inputs, and print
   the ``kernels`` JSON line.

Each of the paths in 7, 8 and 9 runs with every launch count set to 0
just before it and read just after; launches made to compare a kernel
with its plain version count nowhere.  Peak device memory is printed as
the process's peak and as the peak above what the phase found allocated
(earlier phases keep their check inputs for the timing phase).

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
# the tensor cores — every kernel here does f32 arithmetic on CUDA cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# Tolerances, kernel vs plain version on the same card inputs:
#   f32 / int8 outputs: 1e-5 — both sum in f32, in another order (the
#   plain version's reductions, the kernel's sequential l loop and FMAs);
#   bf16 outputs: 3e-2 — the single final rounding to bf16 can land one
#   bf16 step apart when the f32 sums differ in their last bit.
TOL = {"f32": 1e-5, "int8": 1e-5, "bf16": 3e-2}
# engine scores and held-out logits / loss, kernels vs plain path: f32
# summation order through the pooling, the interaction and two MLPs
SCORE_TOL = 1e-4
# the f32-accumulation audit (reference tests/test_kernels.py:84-107): a bf16
# bag at L=16, D=128 within rtol 5e-3 of an f32 oracle
AUDIT_RTOL = 5e-3

B, L, D, F = 256, 4, 16, 27
BIG_TABLE = 10131227            # the largest Kaggle table
EVAL_STEPS = range(10_000, 10_012)


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


def _kernels():
    """Every kernel wrapper of the port by its kernel's name; each carries
    its launch count."""
    from repro_torch.kernels import dot_interaction, embedding_bag, qr_gather, serve_path

    return {"fused_serve_pool": serve_path.fused_serve_pool,
            "dot_interaction": dot_interaction.dot_interaction,
            "qr_gather": qr_gather.qr_gather,
            "qr_gather_quant": qr_gather.qr_gather_quant,
            "qr_embedding_bag": embedding_bag.qr_embedding_bag}


def _zero_counts():
    for fn in _kernels().values():
        fn.launches = 0


def _read_counts():
    return {name: fn.launches for name, fn in _kernels().items()}


def _check_counts(path, counts, expected):
    """Fail unless the path launched exactly ``expected`` of each kernel
    (kernels it does not name: none)."""
    want = {name: expected.get(name, 0) for name in counts}
    shown = ", ".join(f"{k} {v}" for k, v in counts.items() if v or want[k])
    print(f"  launches ({path}): {shown}")
    if counts != want:
        _fail(f"{path}: launch counts {counts}, expected {want}")


def _qr_pair(torch, gen, size, d, rows_scale=0.05):
    """A random f32 QR pair (c=4) for a table of ``size`` categories."""
    m = -(-size // 4)
    w_rem = torch.randn((m, d), generator=gen, device="cuda") * rows_scale
    w_quo = torch.randn((-(-size // m), d), generator=gen, device="cuda") * rows_scale
    return m, w_rem, w_quo


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


def _hold(torch, name, kind, got, want):
    """Fail unless ``got`` matches ``want`` in shape, dtype and value."""
    if got.shape != want.shape or got.dtype != want.dtype:
        _fail(f"{name}: {tuple(got.shape)} {got.dtype} vs plain {tuple(want.shape)} {want.dtype}")
    err = _max_err(torch, got, want)
    tol = TOL[kind] * (1.0 + float(want.float().abs().max()))
    print(f"  {name:34s} max|err| {err:.3e} (tol {tol:.1e})")
    if not err <= tol or not torch.isfinite(got.float()).all():
        _fail(f"{name} disagrees with its plain version")
    return err


def check_qr_gather(torch, gen):
    """K1 and K5 against their plain versions on the largest Kaggle table;
    returns the worst errors and the timing inputs."""
    from repro_torch.kernels import ops, qr_gather, ref
    from repro_torch.serve.quantize import quantize_table

    m, w_rem, w_quo = _qr_pair(torch, gen, BIG_TABLE, D)
    ids = _zipf_ids(torch, gen, (B,), BIG_TABLE)
    rem, quo = ids % m, ids // m
    k1 = 0.0
    for kind, (wr, wq) in (("f32", (w_rem, w_quo)), ("bf16", (w_rem.bfloat16(), w_quo.bfloat16()))):
        for op in ("mult", "add"):
            got = qr_gather.qr_gather(rem, quo, wr, wq, op=op)
            want = ref.qr_gather(rem, quo, wr, wq, op=op)
            torch.cuda.synchronize()
            k1 = max(k1, _hold(torch, f"K1 {kind} {op} N={B}", kind, got, want))
    ids3 = _zipf_ids(torch, gen, (4, 8, 8), BIG_TABLE)
    _zero_counts()
    got = ops.qr_lookup(ids3, w_rem, w_quo)
    _check_counts("ops.qr_lookup, 3-D idx", _read_counts(), {"qr_gather": 1})
    k1 = max(k1, _hold(torch, "K1 3-D idx via ops.qr_lookup", "f32", got,
                       ops.qr_lookup(ids3, w_rem, w_quo, use_kernel=False)))

    qa, qb = quantize_table(w_rem), quantize_table(w_quo)
    quant_args = (rem, quo, qa["q"], qb["q"], qa["scale"], qa["zp"], qb["scale"], qb["zp"])
    k5 = 0.0
    for op in ("mult", "add"):
        got = qr_gather.qr_gather_quant(*quant_args, op=op)
        want = ref.qr_gather_quant(*quant_args, op=op)
        torch.cuda.synchronize()
        k5 = max(k5, _hold(torch, f"K5 int8 {op} N={B}", "int8", got, want))
    return k1, k5, (m, rem, quo, w_rem, w_quo, quant_args)


def check_embedding_bag(torch, gen):
    """K3 against its plain version on the largest Kaggle table, and the
    f32-accumulation audit; returns the worst error and timing inputs."""
    from repro_torch.kernels import embedding_bag, ref

    m, w_rem, w_quo = _qr_pair(torch, gen, BIG_TABLE, D)
    ids = _zipf_ids(torch, gen, (B, L), BIG_TABLE)
    rem, quo = ids % m, ids // m
    pick = torch.randint(0, 4, (B, L), generator=gen, device="cuda")
    mask = torch.tensor([0.0, 0.3, 1.0, 1.7], device="cuda")[pick]   # fractional weights
    mask[B - 8:] = 0.0                                               # empty bags
    worst = 0.0
    for kind, (wr, wq) in (("f32", (w_rem, w_quo)), ("bf16", (w_rem.bfloat16(), w_quo.bfloat16()))):
        for op in ("mult", "add"):
            got = embedding_bag.qr_embedding_bag(rem, quo, mask, wr, wq, op=op)
            want = ref.qr_embedding_bag(rem, quo, mask, wr, wq, op=op)
            torch.cuda.synchronize()
            worst = max(worst, _hold(torch, f"K3 {kind} {op} B={B} L={L}", kind, got, want))
            if not (got[B - 8:] == 0).all():
                _fail(f"K3 {kind} {op}: an empty bag is not exactly zero")

    # the audit: positive rows, so a bf16 running sum's error compounds
    am, aq = 64, 8
    ar = (torch.randn((am, 128), generator=gen, device="cuda").abs() + 0.5).bfloat16()
    aw = (torch.randn((aq, 128), generator=gen, device="cuda").abs() + 0.5).bfloat16()
    aidx = torch.randint(0, am * aq, (8, 16), generator=gen, device="cuda")
    ones = torch.ones((8, 16), device="cuda")
    for op in ("mult", "add"):
        got = embedding_bag.qr_embedding_bag(aidx % am, aidx // am, ones, ar, aw, op=op)
        a, b = ar.float()[aidx % am], aw.float()[aidx // am]
        oracle = (a * b if op == "mult" else a + b).sum(dim=1)
        rel = float(((got.float() - oracle).abs() / oracle.abs()).max())
        print(f"  K3 audit bf16 {op} B=8 L=16 D=128 max rel err {rel:.3e} (rtol {AUDIT_RTOL:.0e})")
        if not rel <= AUDIT_RTOL:
            _fail(f"K3 fails the f32-accumulation audit ({op})")
    return worst, (m, rem, quo, mask, w_rem, w_quo)


def serve_full_width(torch):
    """Serve the full-width int8 DLRM-Criteo; returns the main path's launch
    counts, the engine and its requests."""
    import numpy as np

    from repro_torch.configs import dlrm_criteo
    from repro_torch.launch.serve import request_stream
    from repro_torch.models.dlrm import dlrm_init
    from repro_torch.serve.quantize import memory_report, quantize_params
    from repro_torch.serve.recsys import RecsysEngine

    cfg = dataclasses.replace(dlrm_criteo.config(reduced=False), use_kernel=True)
    base = torch.cuda.memory_allocated()
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

    _zero_counts()
    uids = [engine.submit(dense, bags) for dense, bags in main]
    done = engine.run_until_drained()
    counts = _read_counts()
    m = engine.metrics()
    peak = torch.cuda.max_memory_allocated()

    scores = np.array([done[u].score for u in uids], dtype=np.float64)
    if len(scores) != len(main) or not np.isfinite(scores).all():
        _fail("not every request was scored with a finite value")
    waves, n_tables = m["waves"], len(cfg.table_sizes)
    print(f"  served {m['requests']} requests in {waves} waves | p50 {m['p50_ms']:.3f} ms "
          f"p99 {m['p99_ms']:.3f} ms qps {m['qps']:.1f} | peak memory {peak} B "
          f"({peak - base} B above the phase's start) | buckets {m['buckets']}")
    # the serving path: K4 once per table and wave, K2 once per wave
    _check_counts("serve", counts, {"fused_serve_pool": n_tables * waves,
                                    "dot_interaction": waves})

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


def _profile_device(run):
    """``run()`` under ``torch.profiler``: its result, the device's
    microseconds by short kernel name (every kernel and copy), and the
    count of device operations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = run()
    # device-side events only (kernels, copies): a CPU op's device time
    # would count its kernels twice
    on_device = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    dev = {}
    for ev in on_device:
        name = _short_name(ev.key)
        dev[name] = dev.get(name, 0.0) + ev.self_device_time_total
    return out, dev, sum(ev.count for ev in on_device)


def _top_ms(dev_us, per, k=8):
    """The ``k`` largest device times, in ms per unit of work."""
    return {name: us / per / 1e3 for name, us in sorted(dev_us.items(), key=lambda kv: -kv[1])[:k]}


def profile_waves(torch, engine, reqs):
    """Where a full wave's time goes: wall time per wave (no profiler),
    device time per wave (``torch.profiler``, every kernel and copy), and
    the host's time to pad one wave."""
    import numpy as np

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
    (_, pwaves), dev, n_ops = _profile_device(drain)
    wave = [RecRequest(k, np.asarray(d, np.float32), [list(b) for b in bags])
            for k, (d, bags) in enumerate(reqs[:engine.max_batch])]
    t = time.perf_counter()
    for _ in range(5):
        engine._pad_wave(wave)
    pad_ms = (time.perf_counter() - t) / 5 * 1e3
    out = {"requests": len(reqs), "waves": waves, "wall_ms_per_wave": wall / waves * 1e3,
           "device_ms_per_wave": sum(dev.values()) / pwaves / 1e3,
           "host_pad_ms_per_full_wave": pad_ms,
           "device_ops_per_wave": n_ops / pwaves,
           "top_device_ms_per_wave": _top_ms(dev, pwaves)}
    out["device_busy_share"] = out["device_ms_per_wave"] / out["wall_ms_per_wave"]
    print(f"  per wave: wall {out['wall_ms_per_wave']:.3f} ms, device "
          f"{out['device_ms_per_wave']:.3f} ms (busy {out['device_busy_share']:.3f}), "
          f"host pad {pad_ms:.3f} ms")
    print(json.dumps({"wave_profile": out}))


def _score(api, params, batches):
    """The reference's held-out evaluation: ``loss_fn`` per batch, each
    loss and accuracy read back to the host."""
    losses, accs = [], []
    for batch in batches:
        loss, metrics = api.loss_fn(params, batch)
        losses.append(float(loss))
        accs.append(float(metrics["acc"]))
    return losses, accs


def _eval_run(torch, api, plain, params, batches, mode, lookup, table_bytes, base):
    """One held-out scoring run of the full-width model; returns its
    launch counts.  ``base``: device bytes allocated before the phase."""
    n_tables, n = len(api.cfg.table_sizes), len(batches)
    _score(api, params, batches[:1])        # first call outside the window
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t = time.perf_counter()
    losses, accs = _score(api, params, batches)
    wall = time.perf_counter() - t
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    # one-hot scoring: the lookup kernel once per table and batch, K2 once per batch
    _check_counts(f"eval {mode}", counts, {lookup: n_tables * n, "dot_interaction": n})

    logit_diff = loss_diff = 0.0
    for batch, loss in zip(batches, losses):
        logits = api.predict(params, batch)
        if logits.shape != (B,) or not torch.isfinite(logits).all():
            _fail(f"eval {mode}: logits not finite of shape ({B},)")
        logit_diff = max(logit_diff, float((logits - plain.predict(params, batch)).abs().max()))
        loss_diff = max(loss_diff, abs(loss - float(plain.loss_fn(params, batch)[0])))
    print(f"  {mode}: kernels vs use_kernel=False on {n} batches: max |logit diff| "
          f"{logit_diff:.3e}, max |loss diff| {loss_diff:.3e} (tol {SCORE_TOL:.0e})")
    if not (logit_diff <= SCORE_TOL and loss_diff <= SCORE_TOL):
        _fail(f"eval {mode}: kernel logits or loss disagree with the plain route")

    _, dev, n_ops = _profile_device(lambda: _score(api, params, batches))
    prof = {"mode": mode, "batches": n, "batch_size": B, "heldout_bce": sum(losses) / n,
            "heldout_acc": sum(accs) / n, "wall_ms_per_batch": wall / n * 1e3,
            "device_ms_per_batch": sum(dev.values()) / n / 1e3,
            "device_ops_per_batch": n_ops / n, "table_bytes": table_bytes,
            "peak_memory_bytes": peak, "peak_above_phase_start_bytes": peak - base,
            "top_device_ms_per_batch": _top_ms(dev, n)}
    prof["device_busy_share"] = prof["device_ms_per_batch"] / prof["wall_ms_per_batch"]
    print(f"  {mode}: held-out BCE {prof['heldout_bce']:.5f} acc {prof['heldout_acc']:.5f} | "
          f"per batch: wall {prof['wall_ms_per_batch']:.3f} ms, device "
          f"{prof['device_ms_per_batch']:.3f} ms (busy {prof['device_busy_share']:.3f}) | "
          f"tables {table_bytes} B | peak memory {peak} B ({peak - base} B above the "
          f"phase's start)")
    print(json.dumps({"eval_profile": prof}))
    return counts


def eval_full_width(torch):
    """Score the 12 held-out batches with the full-width one-hot
    DLRM-Criteo, f32 tables then int8; returns each run's launch counts."""
    from repro_torch.configs import dlrm_criteo
    from repro_torch.configs.common import Shape
    from repro_torch.serve.quantize import quantize_params, table_bytes

    cfg = dataclasses.replace(dlrm_criteo.config(reduced=False), use_kernel=True)
    api = dlrm_criteo.api(cfg)
    plain = dlrm_criteo.api(dataclasses.replace(cfg, use_kernel=False))
    shape = Shape("bench", 1, B, "train")        # the reference's paper_tables shape
    base = torch.cuda.memory_allocated()
    batches = [api.batch_fn(step, shape) for step in EVAL_STEPS]
    params = api.init(torch.Generator(device="cuda").manual_seed(0))
    counts = {"eval_f32": _eval_run(torch, api, plain, params, batches, "f32", "qr_gather",
                                    table_bytes(params), base)}
    qparams = quantize_params(params, mode="int8")
    del params                                   # the int8 run holds only int8 tables
    counts["eval_int8"] = _eval_run(torch, api, plain, qparams, batches, "int8",
                                    "qr_gather_quant", table_bytes(qparams), base)
    return counts


def drive_bag_path(torch, gen):
    """K3's own entry point, ``ops.qr_bag_lookup``: as the reference's
    kernel bench calls it (B=32, L=8, m=2048, q=16, D=128, every slot on)
    and on the largest Kaggle table (B=256, L=4, D=16, fractional weights);
    returns the launch counts and the bench shape's inputs."""
    from repro_torch.kernels import ops

    m, q, d = 2048, 16, 128
    bench = (torch.randint(0, m * q, (32, 8), generator=gen, device="cuda"),
             torch.ones((32, 8), device="cuda"),
             torch.randn((m, d), generator=gen, device="cuda"),
             torch.randn((q, d), generator=gen, device="cuda"))
    _, big_rem, big_quo = _qr_pair(torch, gen, BIG_TABLE, D)
    big = (_zipf_ids(torch, gen, (B, L), BIG_TABLE),
           torch.rand((B, L), generator=gen, device="cuda"), big_rem, big_quo)
    _zero_counts()
    outs = [ops.qr_bag_lookup(*args) for args in (bench, big)]
    counts = _read_counts()
    _check_counts("bag", counts, {"qr_embedding_bag": 2})
    for name, args, out in (("bench B=32 L=8 D=128", bench, outs[0]),
                            (f"Kaggle B={B} L={L} D={D}", big, outs[1])):
        _hold(torch, f"ops.qr_bag_lookup {name}", "f32", out,
              ops.qr_bag_lookup(*args, use_kernel=False))
    return counts, bench


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


def _distinct(ids, live=None):
    return int((ids if live is None else ids[live]).unique().numel())


def _gather_bound(rem, quo, row_bytes, ops_per_elem):
    """K1 / K5: ids once, each distinct gathered row once, the f32 or table
    dtype output once (``row_bytes`` is a stored row's bytes, and the
    output's width is ``D`` of 4 bytes at most); f32 operations per output
    element."""
    n = rem.numel()
    nbytes = 2 * n * 4 + (_distinct(rem) + _distinct(quo)) * row_bytes + n * D * 4
    return nbytes, n * D * ops_per_elem


def _bag_bound(rem, quo, mask, d):
    """K3 on f32 tables: ids and mask once, each distinct live row once,
    the pooled output once; combine, weight and add per live element."""
    live = mask != 0
    b = rem.shape[0]
    nbytes = 3 * rem.numel() * 4 + (_distinct(rem, live) + _distinct(quo, live)) * d * 4 \
        + b * d * 4
    return nbytes, int(live.sum()) * d * 3


def _bound(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def measure(torch, gen, k4_inputs, x, qr_inputs, bag_inputs, bench_bag, counts, errs):
    """The ``kernels`` JSON entries: each kernel's time on the card at the
    main path's shapes, its plain version's, its bound from these inputs, a
    PyTorch yardstick where one exists, and its launches on every path."""
    import torch.nn.functional as tf

    from repro_torch.kernels import dot_interaction, embedding_bag, qr_gather, ref, serve_path

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

    # K1 and K5 on the largest Kaggle table, N=256 Zipf ids
    _, g_rem, g_quo, gw_rem, gw_quo, quant_args = qr_inputs
    k1_args = (g_rem, g_quo, gw_rem, gw_quo)
    k1_ms = _time_ms(torch, lambda: qr_gather.qr_gather(*k1_args), 200)
    k1_plain = _time_ms(torch, lambda: ref.qr_gather(*k1_args), 50)
    k1_yard = _time_ms(torch, lambda: tf.embedding(g_rem, gw_rem) * tf.embedding(g_quo, gw_quo),
                       200)
    k1_bytes, k1_ops = _gather_bound(g_rem, g_quo, D * 4, 1)
    # ... and at the reference kernel bench's shape (m=2048, q=16, D=128, N=512)
    bm, bq, bd = 2048, 16, 128
    b_ids = torch.randint(0, bm * bq, (512,), generator=gen, device="cuda")
    b_args = (b_ids % bm, b_ids // bm, torch.randn((bm, bd), generator=gen, device="cuda"),
              torch.randn((bq, bd), generator=gen, device="cuda"))
    b_n = b_ids.numel()
    b_bytes = 2 * b_n * 4 + (_distinct(b_args[0]) + _distinct(b_args[1])) * bd * 4 + b_n * bd * 4
    k1_bench = {"shape": "f32 m=2048 q=16 D=128 N=512 uniform ids (kernels_bench)",
                "ms": _time_ms(torch, lambda: qr_gather.qr_gather(*b_args), 200),
                "plain_ms": _time_ms(torch, lambda: ref.qr_gather(*b_args), 50),
                "bound_ms": _bound(b_bytes, b_n * bd)[0],
                "yardstick_ms": _time_ms(torch, lambda: tf.embedding(b_args[0], b_args[2])
                                         * tf.embedding(b_args[1], b_args[3]), 200)}

    k5_ms = _time_ms(torch, lambda: qr_gather.qr_gather_quant(*quant_args), 200)
    k5_plain = _time_ms(torch, lambda: ref.qr_gather_quant(*quant_args), 50)
    q_rem, q_quo, q_ra, q_qa, s_ra, z_ra, s_qa, z_qa = quant_args

    def k5_library():
        def rows(ids, q, scale, zp):
            return ((tf.embedding(ids, q).float() - tf.embedding(ids, zp).float())
                    * tf.embedding(ids, scale).float())
        return rows(q_rem, q_ra, s_ra, z_ra) * rows(q_quo, q_qa, s_qa, z_qa)

    k5_yard = _time_ms(torch, k5_library, 200)
    k5_bytes, k5_ops = _gather_bound(q_rem, q_quo, D + 3, 5)

    # K3 on the largest Kaggle table, B=256, L=4, fractional weights, op=add
    _, c_rem, c_quo, c_mask, cw_rem, cw_quo = bag_inputs
    k3_args = (c_rem, c_quo, c_mask, cw_rem, cw_quo)
    k3_ms = _time_ms(torch, lambda: embedding_bag.qr_embedding_bag(*k3_args, op="add"), 200)
    k3_plain = _time_ms(torch, lambda: ref.qr_embedding_bag(*k3_args, op="add"), 50)
    k3_yard = _time_ms(torch, lambda: (
        tf.embedding_bag(c_rem, cw_rem, mode="sum", per_sample_weights=c_mask)
        + tf.embedding_bag(c_quo, cw_quo, mode="sum", per_sample_weights=c_mask)), 200)
    k3_bytes, k3_ops = _bag_bound(c_rem, c_quo, c_mask, D)
    # ... and at the reference kernel bench's shape (B=32, L=8, D=128, mult)
    e_idx, e_mask, e_rem, e_quo = bench_bag
    e_args = (e_idx % e_rem.shape[0], e_idx // e_rem.shape[0], e_mask, e_rem, e_quo)
    k3_bench = {"shape": "f32 m=2048 q=16 B=32 L=8 D=128 mult, every slot on (kernels_bench)",
                "ms": _time_ms(torch, lambda: embedding_bag.qr_embedding_bag(*e_args), 200),
                "plain_ms": _time_ms(torch, lambda: ref.qr_embedding_bag(*e_args), 50),
                "bound_ms": _bound(*_bag_bound(*e_args[:3], e_rem.shape[1]))[0],
                "yardstick_ms": None}

    def entry(name, source, replaces, ms, plain_ms, nbytes, ops, extra):
        bound_ms, bound_by = _bound(nbytes, ops)
        by_path = {path: c[name] for path, c in counts.items() if c[name]}
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_path.values()), "max_abs_err": errs[name], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None, "launches_by_path": by_path, **extra}

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
        entry("qr_gather", "src/repro_torch/csrc/qr_gather.cu",
              "src/repro/kernels/qr_gather.py:72", k1_ms, k1_plain, k1_bytes, k1_ops,
              {"shape": f"f32 QR pair of the {BIG_TABLE}-row table (c=4) D={D} N={B} Zipf ids",
               "yardstick": "no single call: two F.embedding calls + the multiply",
               "yardstick_ms": k1_yard, "bench_shape": k1_bench}),
        entry("qr_gather_quant", "src/repro_torch/csrc/qr_gather.cu",
              "src/repro/kernels/qr_gather.py:132", k5_ms, k5_plain, k5_bytes, k5_ops,
              {"shape": f"int8 QR pair of the {BIG_TABLE}-row table (c=4) D={D} N={B} Zipf ids",
               "yardstick": "no single call: six F.embedding calls (q, scale, zp of each "
                            "table) + dequant + multiply",
               "yardstick_ms": k5_yard}),
        entry("qr_embedding_bag", "src/repro_torch/csrc/embedding_bag.cu",
              "src/repro/kernels/embedding_bag.py:78", k3_ms, k3_plain, k3_bytes, k3_ops,
              {"shape": f"f32 QR pair of the {BIG_TABLE}-row table (c=4) B={B} L={L} D={D} "
                        "add, fractional weights",
               "yardstick": "no single call for a pair: two F.embedding_bag(mode='sum', "
                            "per_sample_weights=) calls + an add",
               "yardstick_ms": k3_yard, "bench_shape": k3_bench}),
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
    print("[K1/K5] qr_gather and qr_gather_quant vs plain")
    k1_err, k5_err, qr_inputs = check_qr_gather(torch, gen)
    print("[K3] qr_embedding_bag vs plain, and the f32-accumulation audit")
    k3_err, bag_inputs = check_embedding_bag(torch, gen)
    print("[serve] full-width DLRM-Criteo, int8 QR tables")
    counts = {}
    counts["serve"], engine, reqs = serve_full_width(torch)
    print("[profile] where a full wave's time goes")
    profile_waves(torch, engine, reqs[:1024])
    del engine
    print("[eval] full-width one-hot DLRM-Criteo, 12 held-out batches of 256")
    counts.update(eval_full_width(torch))
    print("[bag] ops.qr_bag_lookup, K3's own entry point")
    counts["bag"], bench_bag = drive_bag_path(torch, gen)
    print("[time] CUDA events")
    errs = {"fused_serve_pool": k4_err, "dot_interaction": k2_err, "qr_gather": k1_err,
            "qr_gather_quant": k5_err, "qr_embedding_bag": k3_err}
    kernels = measure(torch, gen, k4_inputs, x, qr_inputs, bag_inputs, bench_bag, counts, errs)
    for k in kernels:
        if k["launches"] == 0:
            _fail(f"{k['name']} was launched on no path")
    print(f"  card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Serving launcher: ``python -m repro_torch.launch.serve --arch dlrm-criteo``.

Dispatches on the arch's model family, as the reference launcher does.
An LM arch (``tinyllama-1.1b``, ``qwen3-14b``, ``yi-34b``, ``granite-8b``,
``arctic-480b``, ``deepseek-v2-236b``, ``mamba2-370m``, ``zamba2-1.2b``,
``seamless-m4t-large-v2``, ``llava-next-34b``) boots the wave-batched
``ServeEngine`` on the reduced config (prefill + KV-cache decode, MLA's
latent cache for DeepSeek-V2, the SSM state and conv-window caches for
the SSM family, the cross-attention K/V for the encoder-decoder, zero
stub frames or patches for the multimodal archs, the vocabulary through
K1 on the card):
``--requests`` prompts of 4 and 7 tokens, ``--batch-size`` per wave,
``--max-len``, ``--max-new-tokens`` and ``--temperature``, and reports
requests, tokens and seconds.  A rec-family arch boots the
continuous-batching ``RecsysEngine`` for a rec-family arch
(``dlrm-criteo`` with the fused serving and interaction kernels on, or
``dcn-criteo``) over post-training-quantized tables (``--quantize
{f32,bf16,int8}``) with a hot-row cache (``--cache-rows N``, on by default
with 4096 rows, device- or host-resident via ``--cache-impl``), feeds it a
Zipfian synthetic request stream, and reports table bytes, p50/p99 wave
latency, QPS and the cache's hit rate.  Runs on ``--device cuda`` unless
told otherwise.  The model is the arch's reduced config, as in the
reference launcher, or a memory plan of it: ``--plan PATH`` loads one
(written by either package), ``--plan-budget-mb MB`` solves one at that
table byte budget and ``--plan-dims mixed`` (or ``4,8,16``) over a width
ladder (``launch/plan_cli.py``).

Observability and online re-planning, as in the reference launcher:
``--trace PATH`` writes a Chrome-trace JSON of per-wave stage timelines,
``--metrics-out PATH`` the metrics registry as JSONL, and
``--replan-interval N`` drains and runs one drift check every N requests,
re-solving and hot-swapping the plan when drift persists, within
``--replan-budget-mb`` (default: the plan's budget, else the f32 table
footprint).  Each of them turns the engine's observability on.

``--mesh-devices N`` serves the tables sharded over N ranks
(``dist.serve_placement``: replicate small sub-tables, row-shard big ones,
fetch remote rows over the all-to-all exchange).  It runs under
``torchrun`` with a world of N, every rank on the same request stream
(gloo on the CPU; on the card NCCL when there is a card per rank, else
gloo with every rank's tensors on its card), and raises otherwise; rank 0
prints:

    torchrun --nproc_per_node 2 -m repro_torch.launch.serve --device cpu --mesh-devices 2
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os

import numpy as np
import torch
import torch.distributed

from .plan_cli import add_plan_args

__all__ = ["request_stream", "main"]


def request_stream(rng: np.random.Generator, sizes, dense_dim: int, n: int,
                   max_bag: int):
    """``n`` synthetic requests ``(dense, bags)``: dense ~ N(0, 1), one bag
    of 1..``max_bag`` ids per table, ids ``floor(u**1.5 · size)`` (the
    criteo generator's skew)."""
    for _ in range(n):
        dense = rng.normal(size=dense_dim)
        bags = []
        for s in sizes:
            ln = int(rng.integers(1, max_bag + 1))
            u = rng.random(ln)
            bags.append(list(np.floor((u ** 1.5) * s).astype(np.int64)))
        yield dense, bags


def _join_serving(device_arg: str, n: int) -> torch.device:
    """Join the ``torchrun`` world of ``--mesh-devices n`` ranks; returns
    this rank's device."""
    import torch.distributed as dist
    if "WORLD_SIZE" not in os.environ and not dist.is_initialized():
        raise SystemExit(f"--mesh-devices {n} serves one rank per device: run it under "
                         f"torchrun --nproc_per_node {n} -m repro_torch.launch.serve ...")
    world = dist.get_world_size() if dist.is_initialized() else int(os.environ["WORLD_SIZE"])
    if world != n:
        raise SystemExit(f"--mesh-devices {n} but the torchrun world has {world} ranks")
    device = torch.device(device_arg)
    if device.type == "cuda":
        count = torch.cuda.device_count()
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) % count)
        torch.cuda.set_device(device)
        # NCCL takes one rank per card; more ranks than cards share them through gloo
        backend = "nccl" if world <= count else "gloo"
    else:
        backend = "gloo"
    if not dist.is_initialized():
        kw = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method="env://", **kw)
    return device


def _serve_lm(mod, args):
    """The reference's ``_serve_lm``: the reduced config's parameters from
    seed 0 on ``--device``, ``--requests`` prompts ``1..4`` (two of three)
    and ``1..7``, served through ``ServeEngine``.  A multimodal arch's
    prefill takes zero frames or patches before the tokens, shaped by
    ``api.prefill_inputs`` for the wave's ``(B, plen)``, as the
    reference's launcher passes them.

    One departure from the reference's launcher (ROADMAP §3 finding 13):
    the VLM's prefill fills ``n_patches + plen`` cache rows, and the
    reference's engine decodes at ``pos = plen``, so each of its decode
    steps overwrites a patch row and attends to patch rows only.  Here the
    decode closure writes index ``pos + n_patches`` and the cache holds
    ``max_len + n_patches`` rows, so the VLM decodes where its prefill left
    off; the model functions and the engine are the reference's."""
    import time

    from ..configs.common import Shape
    from ..serve.engine import ServeEngine

    device = torch.device(args.device)
    cfg = mod.config(reduced=True)
    api = mod.api(cfg, device)
    params = api.init(torch.Generator(device=device).manual_seed(0))
    n_extra = len(api.prefill_inputs(Shape("x", 8, 1, "prefill"))) - 1
    offset = getattr(cfg, "n_patches", 0)       # the VLM's patch rows before the text

    def prefill_fn(tokens, cache):
        if n_extra:  # multimodal stubs: zero frames or patches
            structs = api.prefill_inputs(Shape("x", tokens.shape[1] + offset,
                                               tokens.shape[0], "prefill"))
            extra = tuple(torch.zeros(s.shape, dtype=s.dtype, device=device)
                          for s in structs[:-1])
            return api.prefill(params, *extra, tokens, cache)
        return api.prefill(params, tokens, cache)

    engine = ServeEngine(
        prefill_fn=prefill_fn,
        decode_fn=lambda tok, pos, cache: api.decode(params, tok, pos + offset, cache),
        make_cache_fn=lambda b, ml: api.make_cache(b, ml + offset),
        batch_size=args.batch_size, max_len=args.max_len,
        temperature=args.temperature, device=device)

    for i in range(args.requests):
        plen = 4 if i % 3 else 7
        engine.submit(list(range(1, plen + 1)), max_new_tokens=args.max_new_tokens)
    t0 = time.monotonic()
    done = engine.run_until_drained()
    dt = time.monotonic() - t0
    toks = sum(len(r.output) for r in done.values())
    print(f"{args.arch}: served {len(done)} requests / {toks} tokens in {dt:.2f}s "
          f"on {device}")
    for uid in sorted(done)[:3]:
        print(f"  req {uid}: {done[uid].output}")
    return done


def _serve_rec(mod, args):
    from ..serve.cache import DeviceHotRowCache, HotRowCache
    from ..serve.quantize import memory_report, quantize_params
    from ..serve.recsys import RecsysEngine
    from .plan_cli import resolve_plan_args

    sharded = bool(args.mesh_devices and args.mesh_devices > 1)
    if args.replan_interval and sharded:
        raise SystemExit("--replan-interval is single-host "
                         "(swap_plan contract); drop --mesh-devices")
    if sharded and args.cache_impl == "host" and args.cache_rows != 0:
        raise SystemExit("--mesh-devices needs --cache-impl device (or --cache-rows 0)")
    device = _join_serving(args.device, args.mesh_devices) if sharded \
        else torch.device(args.device)
    rank0 = not sharded or torch.distributed.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    obs = None
    if args.trace or args.metrics_out or args.replan_interval:
        from ..obs import Obs
        # the replan controller reads collision telemetry, so
        # --replan-interval turns obs on even without --trace/--metrics-out
        obs = Obs(trace=bool(args.trace), collisions=True)

    plan = resolve_plan_args(mod, args)
    cfg = mod.config(reduced=True, plan=plan) if plan is not None else mod.config(reduced=True)
    if hasattr(cfg, "use_kernel"):           # the DCN has no kernel route
        cfg = dataclasses.replace(cfg, use_kernel=True)
    params = mod.api(cfg, device).init(torch.Generator(device=device).manual_seed(0))
    qparams = quantize_params(params, mode=args.quantize)
    rep = memory_report(params, qparams)
    say(f"{args.arch}: tables {rep['f32_table_bytes']} B f32 -> "
          f"{rep['quant_table_bytes']} B {args.quantize} ({rep['ratio']:.3f}x); "
          f"table widths {rep['table_dims']}")

    # the cache admits combined f32 rows, 4·D bytes each.  With only
    # --cache-mb given, rows stay unbounded so the byte budget binds; an
    # explicit zero (rows or bytes) disables the cache
    cache_bytes = int(args.cache_mb * 2 ** 20) if args.cache_mb is not None else None
    if args.cache_rows == 0 or (cache_bytes is not None and cache_bytes <= 0):
        cache = None
    else:
        cache_rows = (args.cache_rows if args.cache_rows is not None
                      else (None if cache_bytes else 4096))
        if args.cache_impl == "device":
            cache = DeviceHotRowCache(capacity_rows=cache_rows, capacity_bytes=cache_bytes,
                                      device=device)
        else:
            cache = HotRowCache(capacity_rows=cache_rows, capacity_bytes=cache_bytes)
    if sharded:
        # each rank takes an equal slice of a wave: round the batch up to a
        # multiple of the ranks rather than refuse it
        n = args.mesh_devices
        batch = -(-args.batch_size // n) * n
        if batch != args.batch_size:
            say(f"  note: --batch-size {args.batch_size} -> {batch} "
                f"(must be a multiple of --mesh-devices {n})")
        engine = RecsysEngine(cfg, qparams, max_batch=batch, cache=cache,
                              batching=args.batching, device=device, obs=obs,
                              mesh_devices=n, plan=plan)
        pl = engine.placement
        prep = memory_report(params, qparams, placement=pl)
        say(f"  placement: {len(pl.sharded)} sharded / {len(pl.replicated)} replicated "
            f"sub-tables over {pl.n_devices} devices, "
            f"{prep['placement']['table_bytes_per_device']} B/device")
    else:
        engine = RecsysEngine(cfg, qparams, max_batch=args.batch_size, cache=cache,
                              batching=args.batching, device=device, obs=obs)

    ctrl = None
    if args.replan_interval:
        from ..online import ReplanController
        from ..plan.planner import full_table_bytes
        # re-solve budget: explicit flag > the plan's own budget > the
        # uncompressed f32 footprint ("no tighter than full tables")
        if args.replan_budget_mb is not None:
            budget = int(args.replan_budget_mb * 2 ** 20)
        elif plan is not None:
            budget = plan.budget_bytes
        else:
            budget = full_table_bytes(cfg.table_sizes, cfg.emb_dim)
        ctrl = ReplanController(engine, budget_bytes=budget, quantize=args.quantize)
        say(f"  replan: every {args.replan_interval} requests, budget {budget} B")

    rng = np.random.default_rng(0)
    stream = request_stream(rng, cfg.table_sizes, cfg.dense_dim, args.requests, args.max_bag)
    interval = args.replan_interval or args.requests
    done = {}
    for _ in range(0, args.requests, interval):
        for dense, bags in itertools.islice(stream, interval):
            engine.submit(dense, bags)
        done.update(engine.run_until_drained())
        if ctrl is not None:
            decision = ctrl.check()
            if decision is not None and decision.fired:
                rep = ctrl.replans[-1]
                say(f"  replan: drift on features {decision.over} -> swapped plan "
                      f"({rep['plan']['total_bytes']} B, kinds {rep['plan']['kinds']})")
    if ctrl is not None:
        say(f"  replan: {ctrl.checks} windows checked, {len(ctrl.replans)} plan swaps")
    m = engine.metrics()
    say(f"{args.arch}: served {len(done)} requests in {m['waves']} waves | "
          f"p50 {m['p50_ms']:.1f} ms  p99 {m['p99_ms']:.1f} ms  qps {m['qps']:.1f}")
    if cache is not None:
        c = m["cache"]
        say(f"  cache: hit_rate {c['hit_rate']:.3f} ({c['hits']}/{c['lookups']}), "
              f"{c['bytes_cached']} B resident")
    if obs is not None:
        ss = engine.stage_summary()
        parts = "  ".join(f"{s} {ss[s]['sum'] * 1e3 / max(1, ss[s]['count']):.2f}ms"
                          for s in ("probe", "dense", "inflight", "miss_gather", "flush"))
        say(f"  stages (mean/wave): {parts}")
        if rank0:
            obs.save(metrics_path=args.metrics_out, trace_path=args.trace)
        for p in (args.metrics_out, args.trace):
            if p:
                say(f"  obs: wrote {p}")
    for uid in sorted(done)[:3]:
        say(f"  req {uid}: score {done[uid].score:+.4f}")
    if sharded:
        torch.distributed.destroy_process_group()
    return done


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dlrm-criteo")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=96,
                    help="the LM engine's cache length (LM family)")
    ap.add_argument("--max-new-tokens", type=int, default=12,
                    help="tokens to generate per request (LM family)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 samples greedily, else by temperature (LM family)")
    ap.add_argument("--quantize", default="int8", choices=["f32", "bf16", "int8"])
    ap.add_argument("--cache-rows", type=int, default=None,
                    help="hot-row cache row capacity (0 disables the cache; default "
                         "4096, or unbounded rows when --cache-mb alone is given so "
                         "the byte budget binds)")
    ap.add_argument("--cache-mb", type=float, default=None,
                    help="hot-row cache byte budget (admission stops at this many "
                         "MiB of resident f32 rows)")
    ap.add_argument("--cache-impl", default="device", choices=["device", "host"],
                    help="hot-row cache storage: 'device' keeps rows in slabs on the "
                         "serving device, 'host' in a dict on the host")
    ap.add_argument("--batching", default="continuous", choices=["continuous", "waves"],
                    help="'continuous' pipelines waves (dispatch ahead while "
                         "earlier waves settle), 'waves' is the lock-step scheduler")
    ap.add_argument("--max-bag", type=int, default=4,
                    help="max multi-hot ids per categorical feature")
    ap.add_argument("--mesh-devices", type=int, default=None,
                    help="serve the tables sharded across this many ranks, one per "
                         "device, under torchrun with a world of this size")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome-trace/Perfetto JSON of per-wave stage "
                         "timelines to PATH (implies obs on)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics registry as JSONL to PATH (implies obs on)")
    ap.add_argument("--replan-interval", type=int, default=None,
                    help="run the online drift controller: drain and run one detector "
                         "check every N requests, re-solving and hot-swapping the plan "
                         "when drift persists (single device; implies obs on; off by "
                         "default)")
    ap.add_argument("--replan-budget-mb", type=float, default=None,
                    help="byte budget for online re-solves in MiB (default: the current "
                         "plan's budget, or the f32 table footprint when serving "
                         "unplanned)")
    ap.add_argument("--device", default="cuda", help="torch device to serve on")
    add_plan_args(ap)
    args = ap.parse_args(argv)

    from ..configs import get_arch
    mod = get_arch(args.arch)
    if getattr(mod, "FAMILY", "lm") == "rec":
        return _serve_rec(mod, args)
    return _serve_lm(mod, args)


if __name__ == "__main__":
    main()

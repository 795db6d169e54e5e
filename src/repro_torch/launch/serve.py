"""Serving launcher: ``python -m repro_torch.launch.serve --arch dlrm-criteo``.

Boots the continuous-batching ``RecsysEngine`` for a rec-family arch over
post-training-quantized tables (``--quantize {f32,bf16,int8}``), with the
fused serving and interaction kernels on, feeds it a Zipfian synthetic
request stream, and reports table bytes, p50/p99 wave latency and QPS.
Runs on ``--device cuda`` unless told otherwise.  The model is the
arch's reduced config, as in the reference launcher.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

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


def _serve_rec(mod, args):
    from ..models.dlrm import dlrm_init
    from ..serve.quantize import memory_report, quantize_params
    from ..serve.recsys import RecsysEngine

    if args.cache_rows not in (None, 0) or args.cache_mb is not None \
            or args.cache_impl is not None:
        raise SystemExit("the hot-row cache is not ported yet (ROADMAP, modules "
                         "to port: item 11); serve with --cache-rows 0")
    device = torch.device(args.device)
    cfg = dataclasses.replace(mod.config(reduced=True), use_kernel=True)
    gen = torch.Generator(device=device).manual_seed(0)
    params = dlrm_init(cfg, gen, device)
    qparams = quantize_params(params, mode=args.quantize)
    rep = memory_report(params, qparams)
    print(f"{args.arch}: tables {rep['f32_table_bytes']} B f32 -> "
          f"{rep['quant_table_bytes']} B {args.quantize} ({rep['ratio']:.3f}x)")
    engine = RecsysEngine(cfg, qparams, max_batch=args.batch_size,
                          batching=args.batching, device=device)
    rng = np.random.default_rng(0)
    for dense, bags in request_stream(rng, cfg.table_sizes, cfg.dense_dim,
                                      args.requests, args.max_bag):
        engine.submit(dense, bags)
    done = engine.run_until_drained()
    m = engine.metrics()
    print(f"{args.arch}: served {len(done)} requests in {m['waves']} waves | "
          f"p50 {m['p50_ms']:.1f} ms  p99 {m['p99_ms']:.1f} ms  qps {m['qps']:.1f}")
    for uid in sorted(done)[:3]:
        print(f"  req {uid}: score {done[uid].score:+.4f}")
    return done


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dlrm-criteo")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--quantize", default="int8", choices=["f32", "bf16", "int8"])
    ap.add_argument("--cache-rows", type=int, default=None,
                    help="hot-row cache rows; only 0 (no cache) is supported yet")
    ap.add_argument("--cache-mb", type=float, default=None,
                    help="hot-row cache byte budget; not supported yet")
    ap.add_argument("--cache-impl", default=None, choices=["device", "host"],
                    help="hot-row cache storage; not supported yet")
    ap.add_argument("--batching", default="continuous", choices=["continuous", "waves"],
                    help="'continuous' pipelines waves (dispatch ahead while "
                         "earlier waves settle), 'waves' is the lock-step scheduler")
    ap.add_argument("--max-bag", type=int, default=4,
                    help="max multi-hot ids per categorical feature")
    ap.add_argument("--device", default="cuda", help="torch device to serve on")
    args = ap.parse_args(argv)

    from ..configs import get_arch
    mod = get_arch(args.arch)
    if getattr(mod, "FAMILY", "lm") != "rec":
        raise SystemExit(f"{args.arch}: only rec-family archs are ported")
    return _serve_rec(mod, args)


if __name__ == "__main__":
    main()

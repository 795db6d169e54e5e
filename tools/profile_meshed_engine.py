#!/usr/bin/env python3
"""Where ``RecsysEngine(mesh=)`` spends its host time beside the unmeshed
engine, on a (data=1, model=1) mesh.

    python3 tools/profile_meshed_engine.py                  # on the card, NCCL
    PYTHONPATH=src python tools/profile_meshed_engine.py --device cpu --reduced

Builds the int8 DLRM-Criteo (full width unless ``--reduced``), serves
``chip_smoke.py``'s 256 warm-up requests and then ``--requests`` of its
2,048 through each engine under ``cProfile``, and prints per engine the
seconds and waves, how many times DTensor's sharding propagation ran
uncached (``ShardingPropagator.propagate_op_sharding_non_cached`` and
``_propagate_tensor_meta_non_cached``, each a fake-tensor run of an
operation), over the warm-up and over the timed pass, and the profile's
top functions by cumulative time.  A process group of one
(NCCL on the card, gloo on the CPU) stands under the mesh.
"""

from __future__ import annotations

import argparse
import collections
import cProfile
import dataclasses
import io
import os
import pstats
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def _count_propagations():
    """Wrap DTensor's two uncached propagation entries with counters."""
    from torch.distributed.tensor import _sharding_prop as sp
    counts = collections.Counter()
    for name in ("propagate_op_sharding_non_cached", "_propagate_tensor_meta_non_cached"):
        orig = getattr(sp.ShardingPropagator, name)

        def wrapped(self, *args, _orig=orig, _name=name, **kw):
            counts[_name] += 1
            return _orig(self, *args, **kw)

        setattr(sp.ShardingPropagator, name, wrapped)
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=1024)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    import chip_smoke
    from repro_torch.configs import dlrm_criteo
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.dlrm import dlrm_init
    from repro_torch.serve.quantize import quantize_params
    from repro_torch.serve.recsys import RecsysEngine

    counts = _count_propagations()
    cfg = dataclasses.replace(dlrm_criteo.config(reduced=args.reduced), use_kernel=True)
    gen = torch.Generator(device=args.device).manual_seed(0)
    qparams = quantize_params(dlrm_init(cfg, gen, args.device), mode="int8")
    warm, main_reqs = chip_smoke._serve_requests(cfg)
    timed = main_reqs[:args.requests]
    sync = torch.cuda.synchronize if args.device == "cuda" else (lambda: None)
    with tempfile.TemporaryDirectory() as d:
        kw = {"device_id": torch.device("cuda", 0)} if args.device == "cuda" else {}
        dist.init_process_group("nccl" if args.device == "cuda" else "gloo",
                                store=dist.FileStore(os.path.join(d, "store"), 1), rank=0,
                                world_size=1, **kw)
        try:
            mesh = make_local_mesh(1, 1)
            for label, extra in (("unmeshed", {}), ("meshed", {"mesh": mesh})):
                engine = RecsysEngine(cfg, qparams, max_batch=256, device=args.device, **extra)
                counts.clear()
                for dense, bags in warm:
                    engine.submit(dense, bags)
                engine.run_until_drained()
                sync()
                engine.reset_metrics()
                warm_counts = dict(counts)
                counts.clear()
                for dense, bags in timed:
                    engine.submit(dense, bags)
                prof = cProfile.Profile()
                t = time.perf_counter()
                prof.enable()
                engine.run_until_drained()
                sync()
                prof.disable()
                secs = time.perf_counter() - t
                waves = engine.metrics()["waves"]
                print(f"{label}: {len(timed)} requests in {waves} waves, {secs:.4f} s; uncached "
                      f"propagations: warm-up {warm_counts}, timed {dict(counts)}")
                out = io.StringIO()
                pstats.Stats(prof, stream=out).sort_stats("cumtime").print_stats(args.top)
                print(out.getvalue())
        finally:
            dist.destroy_process_group()
    print(f"torch {torch.__version__}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Production-mesh dry run: trace every (arch × shape × mesh) cell's
per-GPU program without a GPU.

For each cell this shows that the distribution config is coherent — the
layouts propagate through every operation, the collectives are issued —
and records the per-GPU footprint the roofline reads.  The parameters,
optimizer state, caches and batches are DTensors of ``meta`` shards over a
fake process group of the production mesh's size (``launch.mesh``), so a
cell allocates nothing and runs the same here and on the card's machine.

Artifacts: ``artifacts/dryrun/<arch>__<shape>__<mesh>.json`` with the
per-GPU flops, bytes and collective wire bytes (by mesh axis), the
collective mix, the kernel wrappers' calls, the argument and peak live
bytes (``launch.cost_analysis``), and the trace's wall time.

The port's layers unroll in Python (the reference's ``lax.scan`` has one
body), so a full-width cell traces every layer: a 32k-token prefill spends
seconds per layer in the flash block loop.  By default a stacked model is
traced at two smaller depths laid out as the full one (``traced_depths``:
1 and 2 for most cells) and each additive figure extrapolated linearly
(``layer_multiplier``: exact for identical layers, which
``tests/test_torch_dryrun.py`` holds against the unrolled count; the peak
of live bytes extrapolated the same way is an estimate).  ``--unroll``
traces the whole depth.

Resumable: existing artifacts are skipped unless --force.  A cell that
fails is recorded with its error and traceback, and the process exits 1.

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape decode_32k --mesh single
  python -m repro_torch.launch.dryrun --all                  # every cell, both meshes
  python -m repro_torch.launch.dryrun --all --mesh single    # single-pod only
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import os
import time
import traceback

__all__ = ["run_cell", "analyze", "layer_multiplier", "traced_depths", "depth", "with_depth",
           "main"]


def depth(cfg):
    """The layer count of a stacked model's repeating unit (``None``: not
    stacked): the LM's and Mamba's layers, the hybrid's blocks, the VLM's
    LM layers, the encoder-decoder's layers where its two stacks are
    equally deep (one unit = an encoder and a decoder layer)."""
    if hasattr(cfg, "lm"):
        return cfg.lm.n_layers
    if hasattr(cfg, "n_blocks"):
        return cfg.n_blocks
    if hasattr(cfg, "enc_layers"):
        return cfg.enc_layers if cfg.enc_layers == cfg.dec_layers else None
    return getattr(cfg, "n_layers", None)


def with_depth(cfg, k: int):
    """``cfg`` with ``k`` repeating units (``depth``)."""
    if hasattr(cfg, "lm"):
        return dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, n_layers=k))
    if hasattr(cfg, "n_blocks"):
        return dataclasses.replace(cfg, n_blocks=k)
    if hasattr(cfg, "enc_layers"):
        return dataclasses.replace(cfg, enc_layers=k, dec_layers=k)
    return dataclasses.replace(cfg, n_layers=k)


def traced_depths(n: int, mesh) -> list[int]:
    """The two smallest depths below ``n`` that every group of the mesh's
    axes divides exactly when it divides ``n``: the rule engine lays a
    stacked leaf's layer dim out by that divisibility, so at these depths
    every layer is laid out as at ``n``.  Fewer than two: ``[]``."""
    from ..dist.sharding import axis_sizes
    sizes = list(axis_sizes(mesh).values())
    groups = {math.prod(c) for r in range(1, len(sizes) + 1)
              for c in itertools.combinations(sizes, r)}
    ks = [k for k in range(1, n) if all((k % g == 0) == (n % g == 0) for g in groups)]
    return ks[:2] if len(ks) >= 2 else []


def _extrapolate(c1, c2, k1: int, k2: int, n: int):
    """``c1 + (n − k1)·(c2 − c1)/(k2 − k1)`` through nested dicts of
    numbers."""
    if isinstance(c1, dict):
        return {k: _extrapolate(c1.get(k, 0), c2.get(k, 0), k1, k2, n)
                for k in set(c1) | set(c2)}
    if isinstance(c1, (int, float)) and not isinstance(c1, bool):
        return c1 + (n - k1) * (c2 - c1) / (k2 - k1)
    return c1


_ADDITIVE = ("flops_per_chip", "hbm_bytes_per_chip", "collective_wire_bytes_per_chip",
             "collective_wire_bytes_by_axis", "collectives", "kernels", "local_ops",
             "memory_analysis")


def layer_multiplier(trace, cfg, depths) -> dict:
    """``trace(cfg)``'s record at ``cfg``'s depth from traces at the two
    ``depths`` (``_extrapolate`` on every additive figure)."""
    n = depth(cfg)
    (k1, k2) = depths
    c1, c2 = trace(with_depth(cfg, k1)), trace(with_depth(cfg, k2))
    out = dict(c1)
    out.update({k: _extrapolate(c1[k], c2[k], k1, k2, n) for k in _ADDITIVE})
    out["depth"] = n
    out["depths_traced"] = [k1, k2]
    return out


def analyze(mod, cfg, shape: str, mesh, unroll: bool = False) -> dict:
    """The per-GPU record of one cell (``cost_analysis.analyze_call``) for
    the arch module ``mod`` at ``cfg`` on ``mesh``: unrolled, or through
    ``layer_multiplier`` for a stacked model."""
    from ..configs import lowerables
    from .cost_analysis import analyze_call

    def trace(c):
        fn, args = lowerables(mod.api(c, device="meta"), shape, mesh)
        return analyze_call(fn, args, mesh)

    depths = [] if unroll or depth(cfg) is None else traced_depths(depth(cfg), mesh)
    if not depths:
        return dict(trace(cfg), depth=depth(cfg), depths_traced="all")
    return layer_multiplier(trace, cfg, depths)


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
             force: bool = False, embedding: str = "qr", unroll: bool = False) -> dict:
    from ..configs import SHAPES, get_arch
    from .mesh import make_production_mesh, mesh_name

    name = mesh_name(multi_pod)
    tag = f"{arch}__{shape}__{name}"
    path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    os.makedirs(out_dir, exist_ok=True)

    record = {"arch": arch, "shape": shape, "mesh": name, "embedding": embedding,
              "kind": SHAPES[shape].kind, "ok": False}
    t0 = time.monotonic()
    try:
        mod = get_arch(arch)
        mesh = make_production_mesh(multi_pod=multi_pod)
        record.update(analyze(mod, mod.config(embedding=embedding), shape, mesh, unroll))
        record["time_trace_s"] = round(time.monotonic() - t0, 2)
        record["devices"] = mesh.size()
        record["ok"] = True
    except Exception as e:  # record the failure: these are bugs to fix
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(record, f, indent=1, default=float)
    os.replace(tmp, path)
    if record["ok"]:
        print(f"[OK] {tag} trace={record['time_trace_s']}s depths={record['depths_traced']} "
              f"flops={record['flops_per_chip']:.3g}")
    else:
        print(f"[FAIL] {tag}: {record['error']}")
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--embedding", default="qr")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--unroll", action="store_true",
                    help="trace every layer (default: two smaller depths, extrapolated)")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    from ..configs import cells
    todo = cells() if args.all else [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    n_ok = n_fail = 0
    for arch, shape in todo:
        for mp in meshes:
            rec = run_cell(arch, shape, mp, args.out, force=args.force, embedding=args.embedding,
                           unroll=args.unroll)
            n_ok += rec["ok"]
            n_fail += not rec["ok"]
    print(f"dry-run complete: {n_ok} ok, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())

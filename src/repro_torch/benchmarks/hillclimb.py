"""Perf-iteration driver: trace one cell again, print its roofline terms.

Usage:
  PYTHONPATH=src python -m repro_torch.benchmarks.hillclimb <arch> <shape> <tag> [--multi]
        [--embedding qr] [--unroll]

Writes ``artifacts/perf/<tag>/<arch>__<shape>__<mesh>.json`` and prints the
three terms (the collective split into NVLink and network), the dominant
one, MODEL/counted flops and the roofline fraction, all derived from the
H100 constants of ``launch.mesh.HW``.  Iterations change code (constrain
calls, accumulation, block sizes) between runs.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("tag")
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--embedding", default="qr")
    ap.add_argument("--unroll", action="store_true")
    args = ap.parse_args(argv)

    from ..launch.dryrun import run_cell
    from .roofline import analyze_cell
    rec = run_cell(args.arch, args.shape, args.multi, os.path.join("artifacts", "perf", args.tag),
                   force=True, embedding=args.embedding, unroll=args.unroll)
    if not rec.get("ok"):
        print("FAIL:", rec.get("error"))
        return 1
    c = analyze_cell(rec)
    print(f"[{args.tag}] {args.arch}/{args.shape} mesh={rec['mesh']} emb={args.embedding}")
    print(f"  compute_t={c['compute_t_s']:.4g}s memory_t={c['memory_t_s']:.4g}s "
          f"collective_t={c['collective_t_s']:.4g}s (NVLink {c['collective_nvlink_t_s']:.4g}s, "
          f"network {c['collective_network_t_s']:.4g}s) dominant={c['dominant']}")
    print(f"  MODEL/counted={c['model_over_counted_flops']:.3f} "
          f"roofline_frac={c['roofline_frac']:.4f} peak={c['peak_gb']:.2f}GB (derived)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

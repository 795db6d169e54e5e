"""Command line for the port's static invariant checker.

``python -m repro_torch.analysis`` runs every registered pass over the
port and exits 1 if any *unsuppressed* finding remains.

Selection::

    python -m repro_torch.analysis --layer 1            # AST only, no torch
    python -m repro_torch.analysis --select ACC-001,WIRE-001
    python -m repro_torch.analysis --skip INJ-001
    python -m repro_torch.analysis --paths src/repro_torch/kernels
    python -m repro_torch.analysis --plan artifacts/plans/custom.json
    python -m repro_torch.analysis --list               # show the registry
    python -m repro_torch.analysis --device cpu         # layer 2 on the CPU

The layer-2 passes run on ``--device`` (``cuda`` by default; with no card
the run raises — nothing falls back to the CPU) and WIRE-001 in a gloo
world of ``--world`` ranks (default 8 on the CPU, 4 on the card, where
every rank shares cuda:0).

``--out report.json`` writes the full JSON report (all findings
including suppressed ones, per-pass telemetry) regardless of the
display format; ``python -m benchmarks.summary_md --analysis report.json
--no-bench`` renders it, as it renders the JAX package's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import load_passes
from .findings import (FORMATS, Finding, apply_suppressions,
                       format_findings, report_dict)
from .registry import Context

__all__ = ["run", "main"]


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static invariant checker of the port (AST lint + "
                    "run-level auditors); exits 1 on unsuppressed findings")
    p.add_argument("--root", default=".", help="repo root to scan")
    p.add_argument("--format", dest="fmt", default="human",
                   choices=FORMATS)
    p.add_argument("--out", default=None,
                   help="also write the full JSON report here")
    p.add_argument("--layer", default="all", choices=("1", "2", "all"),
                   help="1 = AST passes only (no torch import), 2 = "
                        "run-level auditors only")
    p.add_argument("--select", default=None,
                   help="comma-separated rule ids to run (default: all)")
    p.add_argument("--skip", default=None,
                   help="comma-separated rule ids to skip")
    p.add_argument("--paths", nargs="*", default=None,
                   help="scan these files/dirs instead of the port's tree "
                        "(AST passes)")
    p.add_argument("--plan", action="append", default=[],
                   help="extra MemoryPlan JSON for the injectivity "
                        "certifier (repeatable)")
    p.add_argument("--list", action="store_true",
                   help="list registered passes and exit")
    p.add_argument("--device", default="cuda",
                   help="device of the layer-2 passes (default cuda; "
                        "raises without a card)")
    p.add_argument("--world", type=int, default=None,
                   help="ranks of WIRE-001's gloo world (default 8 on the "
                        "CPU, 4 on the card)")
    return p


def _ids(csv: str | None) -> set[str] | None:
    if csv is None:
        return None
    return {s.strip().upper() for s in csv.split(",") if s.strip()}


def _require_device(device: str) -> None:
    """A layer-2 run on a CUDA device needs a card: no CPU fallback."""
    if device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"--device {device}: no CUDA device is visible; the layer-2 "
                "passes do not fall back to the CPU (pass --device cpu)")


def run(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)
    passes = load_passes(args.layer)
    if args.list:
        for info in sorted(passes.values(), key=lambda i: (i.layer, i.id)):
            print(f"{info.id:10s} L{info.layer} {info.name:24s} "
                  f"{info.description}")
        return 0
    select, skip = _ids(args.select), _ids(args.skip)
    # the registry is process-wide: another layer's passes may be loaded
    chosen = [info for info in sorted(passes.values(),
                                      key=lambda i: (i.layer, i.id))
              if args.layer in ("all", str(info.layer))
              and (select is None or info.id.upper() in select)
              and (skip is None or info.id.upper() not in skip)]
    if any(info.layer == 2 for info in chosen):
        _require_device(args.device)
    world = args.world or (8 if args.device == "cpu" else 4)
    ctx = Context(root=args.root, paths=args.paths, plan_paths=args.plan,
                  device=args.device, world=world)
    findings: list[Finding] = []
    pass_rows: list[dict] = []
    for info in chosen:
        t0 = time.monotonic()
        try:
            found = list(info.fn(ctx))
        except Exception as e:
            # a crashed pass is a failed run, not a silent skip
            found = [Finding(rule=info.id, layer=info.layer,
                             path=f"analysis://pass/{info.id}", line=0,
                             message=f"pass crashed: {e!r}")]
        findings += found
        pass_rows.append({
            "id": info.id, "name": info.name, "layer": info.layer,
            "description": info.description,
            "seconds": round(time.monotonic() - t0, 3),
            "findings": len(found),
            "notes": ctx.notes.get(info.id),
        })
    findings = apply_suppressions(findings, ctx.sources())
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    print(format_findings(findings, args.fmt, passes=pass_rows,
                          root=args.root))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report_dict(findings, pass_rows, args.root), f,
                      indent=2)
    return 1 if any(not f.suppressed for f in findings) else 0


def main() -> None:
    sys.exit(run())

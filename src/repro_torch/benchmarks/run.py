"""Benchmark harness of the port: the paper's tables and figures, the
kernel bench, the dry run's roofline rows (derived from the H100
constants, from the records under ``artifacts/dryrun``), then the memory
planner's fast section.  ``python -m repro_torch.benchmarks.run
[--only SUBSTR] [--device cpu]`` prints ``name,us_per_call,derived`` CSV.

A section that raises is reported as a ``<section>/ERROR`` row (its
traceback on stderr); every section still runs, but the process then
exits 1.  ``--only`` filters sections by substring of their qualified
name (``module.function``).
"""

from __future__ import annotations

import argparse
import sys
import traceback

__all__ = ["harness", "main"]


def harness(sections, argv=None) -> int:
    """Run ``sections`` (each a function of ``device`` returning CSV rows)
    with the command line ``argv``; returns the exit code."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="",
                    help="run only sections whose qualified name "
                         "(module.function) contains this substring")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.only:
        sections = [fn for fn in sections if args.only in f"{fn.__module__}.{fn.__name__}"]

    failures: list[str] = []
    print("name,us_per_call,derived")
    for fn in sections:
        try:
            rows = fn(device=args.device)
        except Exception as e:  # keep the harness running; surface the error
            traceback.print_exc()
            rows = [(f"{fn.__module__}.{fn.__name__}/ERROR", 0, repr(e)[:120])]
        for name, us, derived in rows:
            if "/ERROR" in name:
                failures.append(name)
            print(f"{name},{us},{derived}")
            sys.stdout.flush()
    if failures:
        print(f"# {len(failures)} section(s) failed: {', '.join(failures)}", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    from . import kernels_bench, paper_tables, plan_bench, roofline

    return harness([paper_tables.fig4, paper_tables.fig5, paper_tables.fig6,
                    paper_tables.table1, kernels_bench.rows, roofline.rows, plan_bench.rows],
                   argv)


if __name__ == "__main__":
    sys.exit(main())

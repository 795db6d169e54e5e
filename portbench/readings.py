"""Readings for a cell's limits: the numbers its check compares, over many
seeds in one process, for the program as it runs, for the control (the
plain reference in the program's place, TF32 on) and for planted faults.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 \
        --mode program|control|fault:<name> [--seconds 2]

Each seed is one run of ``run.measure`` with a short window at the cell's
own load (a training cell's checked steps are taken in set-up), and
prints one JSON line of the numbers.  The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="program")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    import torch

    from portbench.lib import device, spec
    cell = spec.resolve(args.workload)
    why = device.missing(cell.chips)
    if why is not None:
        print(f"readings: {why}", file=sys.stderr)
        return 2
    fault = args.mode.split(":", 1)[1] if args.mode.startswith("fault:") else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        got = run.measure(cell, seed, args.seconds, fault=fault,
                          control=args.mode == "control")
        print(json.dumps({"cell": cell.name, "mode": args.mode, "seed": seed,
                          "numbers": got.numbers, "notes": got.notes,
                          "seconds": time.perf_counter() - t0}), flush=True)
        del got
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

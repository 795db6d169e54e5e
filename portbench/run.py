"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up (imports, the port's kernel build
into ``build/repro_torch/`` and Python's bytecode into ``build/pycache/``
on a checkout's first run, inputs made from the seed, warm-up) is
``setup_s``; then the window measures for
``--seconds``; with ``--trace 1`` a traced stretch follows and the result
carries the per-layer metrics instead of the end-to-end ones.  Then the
program's state is freed and the plain reference decides ``correct``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown``
when traced), then ``checks``, each compared number beside its limit.
A run without a CUDA card, or with JAX or the JAX package loaded once the
window has closed, exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

GIB = float(1 << 30)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def measure(cell, seed: int, seconds: float, *, trace: bool = False, device: str = "cuda",
            fault: str | None = None, control: bool = False, t_start: float | None = None):
    """One run of ``cell`` from ``seed``: set-up, the window, with ``trace``
    the traced stretch, the metrics, then the program's state freed and
    the numbers the check compares.  ``setup_s`` counts from ``t_start``
    (the process's start on the command line).  ``fault`` plants a fault
    under the timed path and ``control`` puts the control in the program's
    place, for the harness's tests and the limits' readings; ``device`` is
    the CPU in the harness's tests."""
    import torch

    torch.set_num_threads(1)
    cuda = torch.device(device).type == "cuda"
    bench = cell.driver.Bench(cell, seed, device, fault=fault, control=control)
    t_setup = time.perf_counter()
    t_start = t_setup if t_start is None else t_start
    bench.setup()
    if cuda:
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()          # set-up's objects stay out of the window's collections
    setup_s = time.perf_counter() - t_start
    stages = dict(imports_and_card=t_setup - t_start, **getattr(bench, "stages", {}))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    win = bench.window(seconds)
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    tr, traced = (bench.traced() if trace else (None, {}))
    gc.unfreeze()

    from portbench.lib import peaks
    ctx = types.SimpleNamespace(conf=cell.conf, traffic=cell.traffic, model=cell.model,
                                peaks=peaks.for_device(torch.cuda.get_device_name(0))
                                if cuda else None,
                                window=win, trace=tr, traced=traced, bench=bench)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = cell.readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        found = {name: win["metrics"][q] for name, q in cell.traffic["report"].items()}
        found.update(setup_s=setup_s, peak_mem_gib=peak / GIB)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": found[m["name"]], "unit": m["unit"]}
    del ctx

    bench.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = bench.check()
    if set(numbers) != set(cell.limits):
        raise KeyError(f"the check compares {sorted(numbers)}, the limits file holds "
                       f"{sorted(cell.limits)}")
    return types.SimpleNamespace(window=win, metrics=metrics, peak=peak, trace=tr,
                                 stages=stages, numbers=numbers,
                                 notes=getattr(bench, "notes", {}))


def main(argv=None, *, device: str = "cuda", fault: str | None = None,
         t_start: float = T_START) -> int:
    """Run a cell; returns the exit code.  ``device`` and ``fault`` exist
    for the harness's own tests, which call this function with a planted
    fault or on the CPU: the command line always runs the program as it is,
    on the card."""
    args = parse(argv)
    from portbench.lib import device as dev
    from portbench.lib import guard, spec
    from portbench.lib.compare import within

    cell = spec.resolve(args.workload)
    if device == "cuda":
        why = dev.missing(cell.chips)
        if why is not None:
            print(f"portbench: {why}", file=sys.stderr)
            return 2
    run = measure(cell, args.seed, args.seconds, trace=bool(args.trace), device=device,
                  fault=fault, t_start=t_start)
    checks = {k: {"value": v, "limit": cell.limits[k]["limit"]} for k, v in run.numbers.items()}
    win = run.window
    correct = win["failed"] == 0 and all(within(c["value"], c["limit"]) for c in checks.values())

    loaded = guard.forbidden_loaded()
    if loaded:
        print(f"portbench: the process loaded {loaded}: the benchmark never runs JAX or the "
              "JAX package", file=sys.stderr)
        return 3

    cuda = device == "cuda"
    device_line = (dev.info(cell.chips, run.peak) if cuda else
                   {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0})
    result = {"correct": correct, "attempted": win["attempted"], "failed": win["failed"],
              "metrics": run.metrics, "device": device_line}
    tr = run.trace
    if tr is not None:
        device_line.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top(tr.device_ops),
                               "idle_gaps": tr.top(tr.idle_gaps)}
    result.update(cell=cell.name, seed=args.seed, seconds=args.seconds,
                  card=dev.power_limit() if cuda else "cpu", window_s=win["wall_s"],
                  setup_stages=run.stages, notes=run.notes, checks=checks)
    for name, c in checks.items():
        verdict = "ok" if within(c["value"], c["limit"]) else "FAILS"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    # Python's bytecode cache in the checkout, at a fixed path, written
    # even where the environment asks for none: only a checkout's first run
    # compiles the imports' bytecode.
    sys.pycache_prefix = str(ROOT / "build" / "pycache")
    sys.dont_write_bytecode = False
    sys.exit(main())

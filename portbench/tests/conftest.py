"""Fixtures for the harness's own tests, run with

    python -m pytest portbench/tests            # on the CPU
    python -m pytest portbench/tests -m gpu     # on the card

``tiny_root`` is a copy of the harness and ``BENCHMARK.json`` with small
cells added as files and entries only: DLRM and DCN on ten small tables
and narrow MLPs, under a small scoring mix and a small training mix, each
cell with its limits file.  ``run_cell`` runs a cell of such a copy in a
subprocess through ``run.main`` on the CPU, optionally with a planted
fault, and returns its result line.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

SIZES = [1000, 200, 50000, 12000, 31, 24, 12517, 633, 3, 931]
TINY_CONFIGS = {
    "tiny-dlrm": {"arch": "dlrm", "bottom_mlp": [32, 16], "top_mlp": [32, 16], "use_kernel": True,
                  "optimizer": {"kind": "adagrad", "lr": 0.01, "eps": 1e-10}},
    "tiny-dcn": {"arch": "dcn", "cross_layers": 2, "deep_mlp": [32, 16],
                 "optimizer": {"kind": "amsgrad", "lr": 0.001, "b1": 0.9, "b2": 0.999,
                               "eps": 1e-8}},
}
TINY_MIXES = {
    "tiny-score": {"kind": "score", "quantize": "int8", "inflight": 2, "pool": 8,
                   "report": {"score_samples_per_s": "samples_per_s"},
                   "candidates": {"min": 64, "max": 256}, "stream": {"zipf": 1.5, "noise": 0.5}},
    "tiny-train": {"kind": "train", "report": {"train_samples_per_s": "samples_per_s"},
                   "batch": 256, "pool": 4, "checked_steps": 3,
                   "chunk_steps": 2, "trace_steps": 2, "stream": {"zipf": 1.5, "noise": 0.5}},
}
NUMBERS = {"score": ["score_gap"], "train": ["loss_gap", "grad_gap", "step_gap"]}
TINY_LIMIT = 1e-4     # the CPU's plain route against the reference reads below 1e-5


def add_cell(root: Path, config: str, conf: dict, mix: str, traffic: dict) -> str:
    """Add a configuration, a traffic mix and their cell to the harness at
    ``root`` as new files and new ``BENCHMARK.json`` entries; returns the
    cell's name.  The cell reports the end-to-end metrics its mix names
    under ``report`` and every per-layer metric that moves one of them."""
    pb = root / "portbench"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    if not (pb / "configs" / f"{config}.json").exists():
        (pb / "configs" / f"{config}.json").write_text(json.dumps(conf))
        bench["configs"].append({"name": config, "source": "test", "reduced": [],
                                 "file": f"portbench/configs/{config}.json", "why": "test"})
    if not (pb / "traffic" / f"{mix}.json").exists():
        (pb / "traffic" / f"{mix}.json").write_text(json.dumps(traffic))
    cell = f"{config}.{mix}"
    bench["workloads"].append({"name": cell, "config": config, "traffic": mix, "chips": 1,
                               "why": "test"})
    (pb / "limits" / f"{cell}.json").write_text(json.dumps(
        {n: {"limit": TINY_LIMIT} for n in NUMBERS[traffic["kind"]]}))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and m.get("moves", m["name"]) in traffic["report"]:
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return cell


def copy_harness(root: Path) -> None:
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")


def tiny_conf(name: str) -> dict:
    return dict(table_sizes=SIZES, dense_dim=13, emb_dim=16, param_dtype="float32",
                embedding={"kind": "qr", "num_collisions": 4, "op": "mult", "threshold": 0},
                allow_tf32=False, reduced=[], **TINY_CONFIGS[name])


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("bench")
    copy_harness(root)
    for config in TINY_CONFIGS:
        for mix, traffic in TINY_MIXES.items():
            add_cell(root, config, tiny_conf(config), mix, traffic)
    return root


def run_cell(root: Path, cell: str, *, seed: int = 2147483659, seconds: float = 0.3,
             trace: int = 0, fault=None) -> dict:
    code = ("import sys; sys.path[:0] = [sys.argv[1]]\n"
            "from portbench import run\n"
            "sys.exit(run.main(sys.argv[2:10], device='cpu', fault=sys.argv[10] or None))\n")
    args = [sys.executable, "-c", code, str(root), "--workload", cell, "--seed", str(seed),
            "--seconds", str(seconds), "--trace", str(trace), fault or ""]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(args, capture_output=True, text=True, timeout=600, env=env, cwd=root)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])

"""The harness is driven by data: every configuration, traffic mix and
metric that ``BENCHMARK.json`` names resolves to a file of its own, the
file meets the benchmark's contract, and a new cell comes from new files
and new entries alone."""

import hashlib
import json
import re

import pytest
from conftest import REPO, TINY_MIXES, add_cell, copy_harness, run_cell, tiny_conf

from portbench.lib import spec

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    c = spec.resolve(cell)
    for attr in ("layout", "port", "forward_flops", "reference_forward", "remainder_rows"):
        assert callable(getattr(c.model, attr)), attr
    assert hasattr(c.driver, "Bench")
    assert all(callable(r.read) for r in c.readers.values())
    assert {m["name"] for m in c.end_to_end} == {"setup_s", "peak_mem_gib", *c.traffic["report"]}
    assert len(c.end_to_end) >= 3 and c.per_layer
    assert all("limit" in v for v in c.limits.values())
    assert c.conf["reduced"] == {x["name"]: x for x in BENCH["configs"]}[c.config_name]["reduced"]


def test_benchmark_file_meets_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert all(not p.startswith("/") and ".." not in p and (REPO / p).is_dir()
               for p in BENCH["paths"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
             + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
               for m in BENCH["end_to_end"] + BENCH["per_layer"])
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def _hashes(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_from_new_files_only(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as files
    plus ``BENCHMARK.json`` entries make a cell that runs, with no file that
    was there changed."""
    copy_harness(tmp_path)
    before = _hashes(tmp_path)
    cell = add_cell(tmp_path, "tiny-dcn-new", tiny_conf("tiny-dcn"), "tiny-score-new",
                    TINY_MIXES["tiny-score"])
    (tmp_path / "portbench" / "metrics" / "requests_per_s.new.py").write_text(
        '"""requests_per_s.new: requests the window completed per second."""\n\n\n'
        "def read(ctx):\n"
        '    return ctx.window["attempted"] / ctx.window["wall_s"]\n')
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "requests_per_s.new", "unit": "1/s", "better": "higher",
                               "source": "host_clock", "layer": "scoring entry",
                               "moves": "score_samples_per_s", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    after = _hashes(tmp_path)
    changed = {p for p in before if after.get(p) != before[p]}
    assert changed == {"BENCHMARK.json"}
    assert set(after) - set(before) == {
        "portbench/configs/tiny-dcn-new.json", "portbench/traffic/tiny-score-new.json",
        f"portbench/limits/{cell}.json", "portbench/metrics/requests_per_s.new.py"}
    plain = run_cell(tmp_path, cell)
    assert plain["correct"] is True
    assert {"score_samples_per_s", "setup_s", "peak_mem_gib"} <= set(plain["metrics"])
    traced = run_cell(tmp_path, cell, trace=1)
    assert traced["correct"] is True and traced["metrics"]["requests_per_s.new"]["value"] > 0

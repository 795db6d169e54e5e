"""A cell, resolved by name from ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in files of its own, found by the name the benchmark file
gives it (``<pb>`` is this harness's folder):

  * the configuration: the ``file`` of its ``configs`` entry (JSON), whose
    ``arch`` names the model adapter ``<pb>/models/<arch>.py``;
  * the traffic mix: ``<pb>/traffic/<traffic>.json``, whose ``kind`` names
    the driver ``<pb>/drivers/<kind>.py`` and whose ``report`` names the
    end-to-end metric under which each of the driver's quantities is
    reported (``{"score_samples_per_s": "samples_per_s"}``);
  * a per-layer metric: its reader ``<pb>/metrics/<name>.py``;
  * the cell's limits for ``correct``: ``<pb>/limits/<cell>.json``.

A new cell is new files and new entries; no file that is there changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

HARNESS = Path(__file__).resolve().parents[1]
ROOT = HARNESS.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    conf: dict               # the configuration's file
    traffic_name: str
    traffic: dict            # the traffic mix's file
    limits: dict             # {number: {"limit": …, …}}
    end_to_end: list         # BENCHMARK.json entries this cell reports
    per_layer: list
    model: object            # the model adapter module
    driver: object           # the traffic kind's driver module
    readers: dict            # per-layer metric name -> reader module


def _load(path: Path, tag: str):
    if not path.is_file():
        raise FileNotFoundError(f"the benchmark has no {path.relative_to(ROOT)}")
    mod_name = "portbench_" + tag + "_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"the benchmark has no {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def resolve(workload: str) -> Cell:
    bench = benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[w["config"]]
    conf = _json(ROOT / config["file"])
    traffic = _json(HARNESS / "traffic" / f"{w['traffic']}.json")
    per_layer = [m for m in bench["per_layer"] if _reports(m, workload)]
    return Cell(
        name=workload, chips=w["chips"], config_name=w["config"], conf=conf,
        traffic_name=w["traffic"], traffic=traffic,
        limits=_json(HARNESS / "limits" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
        per_layer=per_layer,
        model=_load(HARNESS / "models" / f"{conf['arch']}.py", "model"),
        driver=_load(HARNESS / "drivers" / f"{traffic['kind']}.py", "driver"),
        readers={m["name"]: _load(HARNESS / "metrics" / f"{m['name']}.py", "metric")
                 for m in per_layer})

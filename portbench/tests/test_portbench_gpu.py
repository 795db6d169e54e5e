"""On the card: the control of every cell, the plain reference in the
program's place with TF32 on (one step below the f32 the configurations
state), at the cell's own size on three seeds, fails at least one of the
cell's numbers on every seed.  Skips without a card."""

import gc
import json

import pytest
import torch
from conftest import REPO

from portbench import run
from portbench.lib import spec

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (2147483701, 2147483702, 2147483703)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    c = spec.resolve(cell)
    for seed in SEEDS:
        numbers = run.measure(c, seed, 2.0, control=True).numbers
        gc.collect()
        torch.cuda.empty_cache()
        assert any(v > c.limits[k]["limit"] for k, v in numbers.items()), (seed, numbers)

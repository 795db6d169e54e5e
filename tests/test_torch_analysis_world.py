"""WIRE-001 of the port's analyzer in a gloo world of 8 ranks on the CPU.

One world (``repro_torch.analysis.wire_audit.run_world``) runs the eight
exchanges once, in a module-scoped fixture.  For each exchange, on every
rank, the bytes intercepted at ``torch.distributed`` equal the port's
closed form, ``dist.wire``'s record and the JAX package's
``repro.dist.accounting`` closed form for the same shapes — pure
arithmetic, which the reference's own full CLI run holds to its compiled
HLO; no JAX device is needed.  The injected run (``REPRO_ANALYSIS_INJECT=
wire``) exits 1, and a world of one rank is a finding, not a pass.
"""

import math
import os

import numpy as np
import pytest

from repro.dist import accounting as jax_accounting
from repro_torch.analysis.cli import run
from repro_torch.analysis.registry import Context
from repro_torch.analysis.wire_audit import (DP_SHAPES, FSDP_SHAPES, SERVE_LOOKUPS,
                                             SERVE_ROWS_PER_RANK, SERVE_WIDTH, audit_rows,
                                             run_world, wire_pass, wire_programs)

N = 8
NAMES = [name for name, _ in wire_programs()]


def _reference_closed_form(name: str) -> float:
    kind, mode = name[:-1].split("[")
    if kind == "dp_psum":
        grads = {k: np.zeros(s, np.float32) for k, s in DP_SHAPES.items()}
        return jax_accounting.grad_wire_bytes(grads, mode, N, pattern="all_reduce")["total_bytes"]
    if kind == "fsdp_rs_gather":
        return sum(jax_accounting.leaf_reduce_bytes(mode, math.prod(s), N,
                                                    pattern="reduce_scatter")
                   + jax_accounting.ring_all_gather_bytes(4.0 * math.prod(s), N)
                   for s in FSDP_SHAPES.values())
    assert kind == "serve_exchange" and SERVE_ROWS_PER_RANK * N > SERVE_LOOKUPS
    return jax_accounting.serve_exchange_wire_bytes(
        SERVE_LOOKUPS, SERVE_WIDTH, N, quantized=mode == "int8",
        row_dtype_bytes=4)["total_bytes"]


@pytest.fixture(scope="module")
def world_rows():
    return run_world(N, "cpu")


def test_the_world_ran_every_exchange(world_rows):
    assert len(world_rows) == N
    assert all([row["name"] for row in rank] == NAMES for rank in world_rows)
    assert not any("error" in row for rank in world_rows for row in rank)
    findings, rows = audit_rows(world_rows)
    assert findings == [] and [r["ranks"] for r in rows] == [N] * len(NAMES)


@pytest.mark.parametrize("i,name", list(enumerate(NAMES)), ids=NAMES)
def test_intercepted_bytes_equal_both_closed_forms(world_rows, i, name):
    want = _reference_closed_form(name)
    assert want > 0
    for rank in world_rows:
        row = rank[i]
        assert row["name"] == name and row["calls"] > 0
        assert row["intercepted_bytes"] == row["closed_form_bytes"] == want
        assert row["wire_bytes"] == want


def test_injected_mismatch_exits_one(world_rows, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_ANALYSIS_INJECT", "wire")
    findings, _ = audit_rows(world_rows)
    assert len(findings) == len(NAMES)
    assert all("drifted apart" in f.message for f in findings)
    assert run(["--device", "cpu", "--select", "WIRE-001"]) == 1
    assert capsys.readouterr().out.count("WIRE-001") == len(NAMES)


def test_a_world_of_one_is_a_finding():
    findings = wire_pass(Context(root=os.getcwd(), device="cpu", world=1))
    assert len(findings) == 1 and "refusing to pass vacuously" in findings[0].message

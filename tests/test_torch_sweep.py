"""The port's compression sweep (``repro_torch.examples.compression_sweep``)
held against the JAX package's (``examples/compression_sweep.py``).

* The stats the port draws on the CPU equal the JAX package's stats of the
  same batches, and every budget's plan and uniform-hash control equal
  the JAX planner's on them, field for field (``plan_differences`` at 0).
* A 5-step short horizon of the plan and the control at two budgets, from
  the port's CPU-drawn parameters (carried into JAX) on the same batches:
  from each of the reference's states the port's loss within rtol 1e-5
  and its gradients within 1e-5 of each leaf's largest |g| (``tests/test_kernels.py``'s f32 tolerance); the
  free-running losses agree to rtol 1e-5 for 3 steps, then split after
  Adagrad's sign-like steps turn roundoff-sized gradients into ±lr moves.
* ``src/repro_torch/benchmarks/reference_sweep.json`` (from
  ``tools/sweep_reference.py``, which ``chip_smoke.py`` holds the card to)
  carries the JAX planner's plans on these stats and each row's
  tolerance.
"""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import plan as jplan
from repro.models import dlrm as jdlrm
from repro.optim.optimizers import adagrad as jadagrad
from repro.train.loop import init_state as jinit_state
from repro.train.loop import make_train_step as jmake_train_step
from repro_torch.convert import state_to_numpy
from repro_torch.data.criteo import batch_at
from repro_torch.examples import compression_sweep as sw
from repro_torch.models.dlrm import DLRMConfig, dlrm_init
from repro_torch.plan import MemoryPlan, plan_differences, stats_from_criteo

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "src" / "repro_torch" / "benchmarks" / "reference_sweep.json"
HORIZON = 5
HORIZON_FRACS = (0.05, 0.25)


@pytest.fixture(scope="module")
def solved():
    """``(port, jax)``: each a list of ``(frac, plan, uniform)``."""
    stats = stats_from_criteo(sw.SPEC, **sw.STATS)
    jstats = jplan.stats_from_batches(
        (batch_at(0, s, sw.STATS["batch_size"], sw.SPEC, device="cpu")["sparse"].numpy()
         for s in range(sw.STATS["num_batches"])), sw.SIZES)
    for a, b in zip(stats, jstats):
        assert a.size == b.size
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.probs, b.probs)
    full = jplan.full_table_bytes(sw.SIZES, sw.DIM)
    ref = []
    for frac in sw.BUDGET_FRACS:
        budget = int(full * frac)
        uni = jplan.uniform_hash_plan(jstats, sw.DIM, budget, arch="dlrm-criteo")
        ref.append((frac, jplan.build_plan(jstats, sw.DIM, budget, arch="dlrm-criteo",
                                           baseline=uni), uni))
    return sw.solve(), ref


def _as_port(jax_plan):
    return MemoryPlan.from_json(jax_plan.to_json())


def test_plans_equal_the_jax_planner(solved):
    port, ref = solved
    assert [f for f, _, _ in port] == list(sw.BUDGET_FRACS)
    for (_, plan, uni), (_, jp, ju) in zip(port, ref):
        assert plan_differences(plan, _as_port(jp), 0.0) == []
        assert plan_differences(uni, _as_port(ju), 0.0) == []
        assert plan.total_bytes <= plan.budget_bytes


def _jax_run(jembedding, tembedding, steps):
    """The reference's training on the port's initial parameters and
    batches: every step's loss, the parameters before each step, and the
    reference's loss-and-gradient function."""
    jcfg = jdlrm.DLRMConfig(table_sizes=sw.SIZES, emb_dim=sw.DIM, embedding=jembedding)
    tcfg = DLRMConfig(table_sizes=sw.SIZES, emb_dim=sw.DIM, embedding=tembedding)
    params = jax.tree.map(jnp.asarray, state_to_numpy(
        dlrm_init(tcfg, torch.Generator().manual_seed(0), "cpu")))
    opt = jadagrad(1e-2)
    state = jinit_state(params, opt)

    def loss_fn(p, b):
        return jdlrm.dlrm_loss_fn(p, b, jcfg)

    step = jax.jit(jmake_train_step(loss_fn, opt))
    losses, before = [], []
    for i in range(steps):
        before.append(jax.tree.map(np.asarray, state["params"]))
        state, m = step(state, _jb(i))
        losses.append(float(m["loss"]))
    return losses, before, jax.jit(jax.value_and_grad(loss_fn, has_aux=True)), tcfg


def _jb(i):
    return {k: jnp.asarray(v.numpy())
            for k, v in batch_at(0, i, sw.BATCH, sw.SPEC, device="cpu").items()}


def _horizon_cases():
    return [f"{kind}/{frac:g}x" for frac in HORIZON_FRACS for kind in ("plan", "uniform-hash")]


@pytest.mark.parametrize("case", _horizon_cases())
def test_short_horizon_tracks_the_reference(solved, case):
    """From each of the reference's first 5 states, on the same batch, the
    port's loss within rtol 1e-5 and its gradients within 1e-5 of each
    leaf's largest |g| (the held-in-lockstep comparison ``[paper]`` uses).
    Free-running, the first 3 steps' losses agree within rtol 1e-5; later
    ones split (plan/0.05x: 1.6e-5 at step 3), as ``PERF.md`` records for
    every table kind."""
    from repro_torch import tree
    from repro_torch.convert import params_from_jax
    from repro_torch.models.dlrm import dlrm_loss_fn
    from repro_torch.train.loop import value_and_grad
    port, ref = solved
    kind, frac = case.split("/")
    i = [f"{f:g}x" for f in sw.BUDGET_FRACS].index(frac)
    pick = 1 if kind == "plan" else 2
    tp, jp = port[i][pick], ref[i][pick]
    want_losses, before, jgrad, tcfg = _jax_run(jp, tp, HORIZON)
    got = sw.train_model(tp, steps=HORIZON, device="cpu")
    np.testing.assert_allclose(got["train_losses"][:3], want_losses[:3], rtol=1e-5)
    grads_of = value_and_grad(lambda p, b: dlrm_loss_fn(p, b, tcfg))
    for s, jparams in enumerate(before):
        batch = batch_at(0, s, sw.BATCH, sw.SPEC, device="cpu")
        (jloss, _), jg = jgrad(jax.tree.map(jnp.asarray, jparams), _jb(s))
        (loss, _), g = grads_of(params_from_jax(jparams, device="cpu"), batch)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        for a, b in zip(jax.tree.leaves(jg), tree.leaves(g)):
            a = np.asarray(a)
            np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                       atol=1e-5 * max(float(np.abs(a).max()), 1e-30))


def test_reference_file_holds_the_jax_plans(solved):
    _, ref = solved
    data = json.loads(REFERENCE.read_text())
    assert data["tool"] == "tools/sweep_reference.py" and data["steps"] == sw.STEPS
    rows = {r["name"]: r for r in data["rows"]}
    assert list(rows) == ["full"] + [f"{k}/{f:g}x" for f in sw.BUDGET_FRACS
                                     for k in ("plan", "uniform-hash")]
    for frac, jp, ju in ref:
        for name, p in ((f"plan/{frac:g}x", jp), (f"uniform-hash/{frac:g}x", ju)):
            assert plan_differences(MemoryPlan.from_json(json.dumps(rows[name]["plan"])),
                                    _as_port(p), 0.0) == []
    for r in rows.values():
        assert r["tol"] == (0.02 if r["abs_dloss"] <= 0.02 else 1.5 * r["abs_dloss"])
        assert abs(r["port_cpu_loss"] - r["loss"]) == pytest.approx(r["abs_dloss"])


def test_sweep_example_runs_and_reports_agreement(capsys):
    rows = sw.main(["--device", "cpu", "--steps", "1", "--budgets", "0.125"])
    out = capsys.readouterr().out
    assert [r["name"] for r in rows] == ["full", "plan/0.125x", "uniform-hash/0.125x"]
    assert "proxy order vs trained order (plan vs uniform-hash): 0.125x" in out
    agree = sw.agreement(rows)
    assert list(agree) == [0.125] and isinstance(agree[0.125], bool)
    assert os.path.basename(sw.__file__) == "compression_sweep.py"

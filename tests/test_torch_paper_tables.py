"""The port's §5 benchmark (``repro_torch.benchmarks.paper_tables``) held
against the JAX package's (``benchmarks/paper_tables.py``).

* every one of the 30 rows counts the reference's parameters (the
  reference's side from ``jax.eval_shape``, so nothing is drawn);
* the short horizon: on the reference's parameters (``convert``) and the
  reference's batches as numpy, ``SHORT_STEPS`` steps through the port's
  training and held-out helpers give the reference's held-out BCE and
  accuracy within rtol 1e-5, for fig4's six rows (the other row kinds:
  ``test_torch_paper_horizon.py``);
* kernel-route scoring on the CPU (the kernels' plain versions) equals
  plain scoring for every DLRM kind, and the launch counts the card must
  show;
* the stream: parameters and batches are drawn on the CPU whatever the
  device, then copied;
* the sections' rows, derived strings and artifact keys equal the
  reference's; the harness's ``ERROR`` rows and exit code.

``SHORT_STEPS`` = 5: the largest step count that holds for every row kind
(``tools/paper_tables_reference.py --horizon``): at 5 steps the largest
relative difference is 6.7e-6 (the path-based row; 1.7e-6 for the
others); at 4 the path row is 1.3e-5 apart, at 6 the threshold-200 row
1.3e-4, at 7 the full and hash rows one example's accuracy.  The
trajectories split there, not in the port: Adagrad's first step is
−lr·g/(|g|+ε), so a roundoff-sized g moves an element by up to 2·lr
either way (a handful of elements, PERF.md).
"""

import importlib.util
import io
import json
import os
from contextlib import redirect_stderr, redirect_stdout

import jax
import numpy as np
import pytest
import torch

from repro.configs import dcn_criteo as jdcn
from repro.configs import dlrm_criteo as jdlrm
from repro.train.loop import init_state as jinit_state
from repro.train.loop import make_train_step as jmake_train_step
from repro_torch import tree
from repro_torch.benchmarks import paper_tables as pt
from repro_torch.benchmarks import run as prun
from repro_torch.configs import dlrm_criteo
from repro_torch.convert import params_from_jax
from repro_torch.data.criteo import CriteoSpec, batch_at

JMODULES = {"dlrm": jdlrm, "dcn": jdcn}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_bench():
    """The JAX package's ``benchmarks/paper_tables.py``, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "reference_paper_tables", os.path.join(ROOT, "benchmarks", "paper_tables.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jpt = _reference_bench()
SPECS = {s.name: s for s in pt.row_specs()}
SHORT_STEPS = 5
RTOL = 1e-5


def _jax_cfg_api(spec):
    jmod = JMODULES[spec.net]
    return jmod.api(jmod.config(reduced=True, **spec.kw))


def short_horizon(name, steps=SHORT_STEPS, seed=0):
    """The reference's held-out (BCE, accuracy) after ``steps`` steps from
    its own parameters on its own batches, and the port's on the same
    parameters and batches (numpy across)."""
    spec = SPECS[name]
    a = _jax_cfg_api(spec)
    params = a.init(jax.random.PRNGKey(seed))
    train = [a.batch_fn(s, jpt.SHAPE) for s in range(steps)]
    held = [a.batch_fn(s, jpt.SHAPE) for s in pt.HELDOUT]
    step = jax.jit(jmake_train_step(a.loss_fn, a.optimizer))
    loss_fn = jax.jit(a.loss_fn)
    state = jinit_state(params, a.optimizer)
    for batch in train:
        state, _ = step(state, batch)
    scored = [loss_fn(state["params"], b) for b in held]
    ref = (float(np.mean([float(l) for l, _ in scored])),
           float(np.mean([float(m["acc"]) for _, m in scored])))

    _, api, _ = pt.setup(pt.MODULES[spec.net], seed=seed, **spec.kw)
    port_params = params_from_jax(jax.tree.map(np.asarray, params), "cpu")

    def to_torch(b):
        return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}

    run = pt.train(api.loss_fn, api.optimizer, port_params, lambda s: to_torch(train[s]),
                   steps, "cpu")
    port = pt.heldout(api.loss_fn, run.state["params"], [to_torch(b) for b in held])
    return ref, port


@pytest.mark.parametrize("name", [n for n in SPECS if n.startswith("fig4/")])
def test_short_horizon_matches_reference(name):
    ref, port = short_horizon(name)
    np.testing.assert_allclose(port, ref, rtol=RTOL, atol=0)


@pytest.mark.parametrize("name", list(SPECS))
def test_parameter_counts_match_reference(name):
    spec = SPECS[name]
    _, _, params = pt.setup(pt.MODULES[spec.net], **spec.kw)
    shapes = jax.eval_shape(_jax_cfg_api(spec).init, jax.random.PRNGKey(0))
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in tree.leaves(params)) == want
    assert [tuple(p.shape) for p in tree.leaves(params)] == [
        tuple(leaf.shape) for leaf in jax.tree.leaves(shapes)]


# K1 launches per 12 held-out batches on the card: one grouped launch per
# batch where every table is a mult/add QR pair; one per pair and batch
# where a threshold keeps some tables full (6, 3 and 1 QR tables of 10)
K1 = {"fig4/dlrm/qr_mult": 12, "fig6/dlrm/qr_mult/thr0": 12, "fig6/dlrm/qr_mult/thr200": 72,
      "fig6/dlrm/qr_mult/thr2000": 36, "fig6/dlrm/qr_mult/thr20000": 12,
      **{f"fig5/dlrm/{op}/c{c}": 12 for op in ("mult", "add") for c in (2, 4, 60)}}


@pytest.mark.parametrize("name", [n for n, s in SPECS.items() if s.net == "dlrm"])
def test_expected_launches_per_row(name):
    spec = SPECS[name]
    cfg, _, _ = pt.setup(dlrm_criteo, **spec.kw)
    want = {"dot_interaction": 12, **({"qr_gather": K1[name]} if name in K1 else {})}
    assert pt.expected_launches(cfg, 12) == want


@pytest.mark.parametrize("name", ["fig4/dlrm/full", "fig4/dlrm/hash", "fig4/dlrm/qr_mult",
                                  "fig5/dlrm/add/c4", "fig5/dlrm/concat/c4",
                                  "fig5/dlrm/feature/c4", "fig6/dlrm/qr_mult/thr200",
                                  "table1/dlrm/path/h16"])
def test_kernel_route_scoring_on_the_cpu_equals_plain(name):
    """``use_kernel=True`` on the CPU runs the kernels' plain versions:
    the same BCE and logits as the plain path, and no launch."""
    spec = SPECS[name]
    cfg, api, params = pt.setup(dlrm_criteo, **spec.kw)
    batches = [api.batch_fn(s, pt.SHAPE) for s in pt.HELDOUT[:3]]
    bce, _ = pt.heldout(api.loss_fn, params, batches)
    k = pt.kernel_scoring(dlrm_criteo, cfg, params, batches, bce, "cpu")
    assert k["abs_dbce"] <= pt.SCORE_TOL and k["max_abs_dlogit"] <= pt.SCORE_TOL
    assert k["launches"] == {} and k["expected_launches"] == {}


def test_stream_is_drawn_on_the_cpu_whatever_the_device(monkeypatch):
    """``run_row`` on another device trains from the CPU's draws: the
    parameters of ``api(cfg, "cpu").init`` and the batches of
    ``batch_at(0, step, 256, spec, device="cpu")``, copied after."""
    seen = {}

    def fake_train(loss_fn, optimizer, params, batch_at_, steps, device):
        seen["params"], seen["batches"], seen["device"] = params, [batch_at_(s) for s in
                                                                   range(steps)], device
        return pt.TrainRun({"params": pt.to_device(params, device)}, [0.0] * steps, 1.0, 0.0)

    def fake_heldout(loss_fn, params, batches):
        seen["heldout"] = batches
        return 0.5, 0.5

    monkeypatch.setattr(pt, "train", fake_train)
    monkeypatch.setattr(pt, "heldout", fake_heldout)
    monkeypatch.setattr(pt, "kernel_scoring", lambda *a: {})
    pt.run_row(dlrm_criteo, embedding="qr", steps=3, device="meta")
    cfg = dlrm_criteo.config(reduced=True)
    want = dlrm_criteo.api(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    for got, w in zip(tree.leaves(seen["params"]), tree.leaves(want)):
        assert got.device.type == "cpu" and torch.equal(got, w)
    spec = CriteoSpec(table_sizes=cfg.table_sizes, zipf=1.5, noise=0.5)
    for s, got in enumerate(seen["batches"]):
        w = batch_at(0, s, 256, spec, device="cpu")
        assert all(got[k].device.type == "cpu" and torch.equal(got[k], w[k]) for k in w)
    assert seen["device"] == "meta"
    assert all(v.device.type == "meta" for b in seen["heldout"] for v in b.values())


def test_training_helper_copies_cpu_batches_and_times_the_steps():
    cfg, api, params = pt.setup(dlrm_criteo, embedding="qr")
    run = pt.train(api.loss_fn, api.optimizer, params, lambda s: api.batch_fn(s, pt.SHAPE),
                   4, "cpu")
    assert len(run.losses) == 4 and all(np.isfinite(run.losses))
    assert run.us_per_step > 0 and 0 <= run.batch_share < 1
    assert int(run.state["step"]) == 4
    # the parameters handed in stay as they were: the step is functional
    again = pt.setup(dlrm_criteo, embedding="qr")[2]
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(params), tree.leaves(again)))


def _run_sections(module, fns, art, monkeypatch):
    monkeypatch.setattr(module, "ART", str(art))
    out = []
    with redirect_stderr(io.StringIO()):
        for fn in fns:
            out += fn()
    files = {f: json.loads((art / f).read_text()) for f in os.listdir(art)}
    return out, files


def test_sections_rows_and_artifacts_match_reference(tmp_path, monkeypatch):
    """With training stubbed on both sides, the sections print the
    reference's row names, times and derived strings, pass ``run_row`` the
    keywords the reference passes ``_train_eval``, and write the
    reference's artifacts (plus the port's ``*_detail.json``)."""
    calls = {"ref": [], "port": []}
    defaults = dict(num_collisions=4, threshold=0, op="mult")

    def ref_stub(mod, **kw):
        calls["ref"].append((mod.ARCH, {**defaults, **kw}))
        return 0.43215, 0.75, 1234, 9.5

    def port_stub(mod, device, **kw):
        calls["port"].append((mod.ARCH, {**defaults, **kw}))
        return pt.RowResult(0.43215, 0.75, 1234, 9.5, 0.1, [0.7] * 10, None)

    monkeypatch.setattr(jpt, "_train_eval", ref_stub)
    monkeypatch.setattr(pt, "run_row", port_stub)
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref_rows, ref_art = _run_sections(jpt, [jpt.fig4, jpt.fig5, jpt.fig6, jpt.table1],
                                      tmp_path / "ref", monkeypatch)
    port_rows, port_art = _run_sections(pt, [pt.fig4, pt.fig5, pt.fig6, pt.table1],
                                        tmp_path / "port", monkeypatch)
    assert port_rows == ref_rows and len(port_rows) == 30
    assert calls["port"] == calls["ref"]
    assert {f: a for f, a in port_art.items() if not f.endswith("_detail.json")} == ref_art
    assert set(ref_art) == {"fig4.json", "fig5.json", "fig6.json", "table1.json"}


def test_harness_reports_errors_and_keeps_going(capsys):
    def broken(device):
        raise RuntimeError("boom")

    def fine(device):
        return [("ok/row", 1.0, f"device={device}")]

    assert prun.harness([broken, fine], ["--device", "cpu"]) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert out[1].startswith(f"{broken.__module__}.broken/ERROR,0,RuntimeError")
    assert out[2] == "ok/row,1.0,device=cpu"
    assert prun.harness([broken, fine], ["--only", "fine"]) == 0
    assert capsys.readouterr().out.splitlines()[1:] == ["ok/row,1.0,device=cuda"]


def test_kernel_bench_needs_a_card():
    from repro_torch.benchmarks import kernels_bench

    with pytest.raises(RuntimeError, match="no card"):
        kernels_bench.rows(device="cpu")


def test_reference_rows_cover_every_row():
    """The committed reference rows (``tools/paper_tables_reference.py``)
    hold one entry per row, with the reference's parameter count and a
    tolerance of 0.02, or 1.5x the row's JAX-vs-port-CPU gap above it."""
    path = os.path.join(os.path.dirname(pt.__file__), "reference_rows.json")
    with open(path) as f:
        ref = json.load(f)
    assert ref["steps"] == 400 and ref["batch"] == pt.BATCH
    assert list(ref["rows"]) == list(SPECS)
    for name, row in ref["rows"].items():
        gap = abs(row["port_cpu_loss"] - row["loss"])
        assert row["tol"] == pytest.approx(0.02 if gap <= 0.02 else 1.5 * gap)
        assert np.isfinite(row["loss"]) and 0 <= row["acc"] <= 1
        _, _, params = pt.setup(pt.MODULES[SPECS[name].net], **SPECS[name].kw)
        assert row["params"] == sum(p.numel() for p in tree.leaves(params))


def test_a_section_runs_on_the_cpu_end_to_end(tmp_path, monkeypatch):
    """``fig6`` through ``run_row`` unstubbed, cut to its threshold-200
    row, 2 steps and 2 held-out batches: the row, its artifact and its
    kernel scoring on the CPU (no launch)."""
    monkeypatch.setattr(pt, "ART", str(tmp_path))
    monkeypatch.setattr(pt, "HELDOUT", range(10_000, 10_002))
    monkeypatch.setattr(pt, "run_row", _two_steps(pt.run_row))
    monkeypatch.setattr(pt, "row_specs", lambda: [SPECS["fig6/dlrm/qr_mult/thr200"]])
    with redirect_stdout(io.StringIO()), redirect_stderr(io.StringIO()) as err:
        rows = pt.fig6(device="cpu")
    assert [r[0] for r in rows] == ["fig6/dlrm/qr_mult/thr200"]
    assert rows[0][2].startswith("test_loss=") and rows[0][2].endswith(";params=637297")
    art = json.loads((tmp_path / "fig6.json").read_text())
    detail = json.loads((tmp_path / "fig6_detail.json").read_text())
    assert set(art["200"]) == {"loss", "acc", "params"}
    assert detail["200"]["kernel"]["launches"] == {}
    assert err.getvalue().count("kernel-route BCE") == 1


def _two_steps(run_row):
    return lambda mod, **kw: run_row(mod, **dict(kw, steps=2))


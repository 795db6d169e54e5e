"""The port's memory planner held against the JAX package's on the same inputs.

Both packages get the same numpy batches or the same ``FeatureStats``, and
every step of the planner is compared: the stats, the quality proxy and
its diagnostics, the candidate ladders, their hulls, the solver's picks
and its notes, and the emitted ``MemoryPlan`` — every field equal, floats
to the bit (``plan_differences`` at 0), since the port copies the
reference's numpy expression for expression.  Plan JSON written by either
package loads in the other.  ``src/repro_torch/benchmarks/reference_plans.json``
(``tools/plan_reference.py``: the JAX planner on the port's CPU-drawn
stats) is held to what the JAX planner gives now, and the port's plans to
it: ``plan_bench``'s 8 reduced cells, the full-width ``[plan]`` plan of
``chip_smoke.py``, and the reference-stream case whose mixed-width plan
falls below the uniform-width one at the 0.05 budget (the greedy solver's
fault, reproduced).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from repro import plan as jplan
from repro.configs import dlrm_criteo as jdlrm_criteo
from repro.core import EmbeddingSpec as JSpec
from repro.core import make_embedding as jmake
from repro.data.criteo import CriteoSpec as JCriteoSpec
from repro.launch import plan_cli as jplan_cli
from repro_torch import plan as tplan
from repro_torch.benchmarks import plan_bench as tbench
from repro_torch.configs import dlrm_criteo
from repro_torch.core import EmbeddingSpec as TSpec
from repro_torch.core import make_embedding as tmake
from repro_torch.data.criteo import CriteoSpec, batch_at
from repro_torch.launch import plan_cli as tplan_cli
from repro_torch.plan import plan_differences

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(ROOT, "src", "repro_torch", "benchmarks", "reference_plans.json")
SIZES = (100, 500, 33, 2000, 3, 70_000)
DIM = 16


def _port_stats(jstats):
    """The JAX package's stats as the port's type (the same arrays)."""
    return [tplan.FeatureStats(size=s.size, ids=s.ids, probs=s.probs) for s in jstats]


def _as_port(jax_plan):
    return tplan.MemoryPlan.from_json(jax_plan.to_json())


def _stats(seed=0, zipf=1.3, n=4096):
    rng = np.random.default_rng(seed)
    cols = [((rng.zipf(zipf, size=n) - 1) % s) for s in SIZES]
    return jplan.stats_from_batches([np.stack(cols, axis=1)], SIZES)


@pytest.fixture(scope="module")
def reference():
    with open(REFERENCE) as f:
        return json.load(f)


# ------------------------------------------------------------------ stats


@pytest.mark.parametrize("multihot", [False, True])
def test_stats_from_the_same_batches_are_equal(multihot):
    rng = np.random.default_rng(3)
    shape = (64, len(SIZES), 5) if multihot else (64, len(SIZES))
    batches = []
    for _ in range(3):
        ids = np.stack([rng.integers(0, s, size=shape[:1] + shape[2:]) for s in SIZES], axis=1)
        if multihot:
            ids[rng.random(ids.shape) < 0.2] = -1                 # padding slots
        batches.append({"sparse": ids})
    want = jplan.stats_from_batches(batches, SIZES)
    got = tplan.stats_from_batches(batches, SIZES)
    # a CPU tensor batch, as the port's generator draws it, gives the same
    got_t = tplan.stats_from_batches([{"sparse": torch.from_numpy(b["sparse"])}
                                      for b in batches], SIZES)
    for w, g, gt in zip(want, got, got_t):
        assert g.size == w.size and g.as_dict() == w.as_dict()
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_array_equal(g.probs, w.probs)
        np.testing.assert_array_equal(gt.probs, w.probs)


def test_merge_streaming_and_power_law_stats_are_equal():
    a, b = _stats(1), _stats(2)
    for x, y in zip(a, b):
        want = jplan.freq.merge_stats(x, y, 3.0, 1.0)
        got = tplan.merge_stats(*_port_stats([x, y]), 3.0, 1.0)
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.probs, want.probs)
    js = jplan.freq.StreamingStats(SIZES, decay=0.9, max_support=50)
    ts = tplan.StreamingStats(SIZES, decay=0.9, max_support=50)
    rng = np.random.default_rng(4)
    for _ in range(4):
        batch = np.stack([rng.zipf(1.2, size=(32, 3)) % s for s in SIZES], axis=1)
        js.update(batch)
        ts.update(batch)
    assert ts.pruned == js.pruned
    for w, g in zip(js.all_stats(), ts.all_stats()):
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_array_equal(g.probs, w.probs)
    for n in SIZES:
        w, g = jplan.power_law_stats(n, 1.2), tplan.power_law_stats(n, 1.2)
        np.testing.assert_array_equal(g.probs, w.probs)


def test_stats_from_criteo_draw_the_ports_cpu_stream():
    """The port's stats come from its generator drawn on the CPU (whatever
    device serves), and equal the JAX package's stats of those batches."""
    spec = CriteoSpec(table_sizes=SIZES, zipf=1.5, noise=0.5)
    got = tplan.stats_from_criteo(spec, num_batches=3, batch_size=128)
    want = jplan.stats_from_batches(
        [batch_at(0, s, 128, spec, device="cpu")["sparse"].numpy() for s in range(3)], SIZES)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_array_equal(g.probs, w.probs)


# ------------------------------------------------------------------ quality


SPECS = [dict(kind="full"), dict(kind="hash", num_collisions=8), dict(kind="qr", num_collisions=4),
         dict(kind="qr", num_collisions=16, op="add"), dict(kind="mixed_radix"),
         dict(kind="mixed_radix", ms=(9, 9, 9))]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: "-".join(map(str, s.values())))
def test_quality_and_diagnostics_are_equal(spec):
    stats = _stats(5)
    for st, n in zip(stats, SIZES):
        if spec.get("ms") and np.prod(spec["ms"]) < n:
            continue
        jmod, tmod = jmake(n, DIM, JSpec(**spec)), tmake(n, DIM, TSpec(**spec))
        jp, tp = jplan.module_partitions(jmod), tplan.module_partitions(tmod)
        assert [(p.num_buckets, type(p).__name__) for p in tp] \
            == [(p.num_buckets, type(p).__name__) for p in jp]
        tst = _port_stats([st])[0]
        assert tplan.proxy_quality(tp, tst) == jplan.proxy_quality(jp, st)
        assert tplan.partition_diagnostics(tp, tst) == jplan.partition_diagnostics(jp, st)
        assert tplan.required_dim(tst) == jplan.required_dim(st)
        for d in (4, 8, 16):
            assert tplan.width_factor(d, DIM, tst) == jplan.width_factor(d, DIM, st)
            assert tplan.dim_proxy_quality(tp, tst, d, DIM) \
                == jplan.dim_proxy_quality(jp, st, d, DIM)
        for p_t, p_j in zip(tp, jp):
            np.testing.assert_array_equal(tplan.sharing(p_t, tst), jplan.sharing(p_j, st))
    samples = [(0.5, 0.9), (0.25, 0.7), (1.0, 1.0)]
    assert tplan.fit_width_exponent(samples) == jplan.fit_width_exponent(samples)


# ------------------------------------------------------- candidates and hulls


@pytest.mark.parametrize("domain", ["train_f32", "serve_int8"])
@pytest.mark.parametrize("dims", [None, (4, 8, 16)])
def test_candidates_and_hulls_are_equal(domain, dims):
    """The ladders (built through each package's factory, priced with each
    package's ``row_bytes``) and their upper hulls, candidate by candidate."""
    stats = _stats(6)
    for f, (st, tst) in enumerate(zip(stats, _port_stats(stats))):
        want = jplan.enumerate_candidates(f, st, DIM, bytes_domain=domain, dims=dims)
        got = tplan.enumerate_candidates(f, tst, DIM, bytes_domain=domain, dims=dims)
        fields = ("label", "rows", "train_bytes", "serve_bytes_int8", "quality", "dim")
        assert [tuple(getattr(c, k) for k in fields) for c in got] \
            == [tuple(getattr(c, k) for k in fields) for c in want]
        assert [c.spec.__dict__ for c in got] == [c.spec.__dict__ for c in want]

        def cost(c):
            return c.bytes(domain)

        assert [c.label for c in tplan.concave_frontier(got, cost)] \
            == [c.label for c in jplan.concave_frontier(want, cost)]
    assert [s.__dict__ for s in tplan.candidate_specs(70_000)] \
        == [s.__dict__ for s in jplan.candidate_specs(70_000)]
    assert tplan.dim_ladder(16) == jplan.dim_ladder(16) == (4, 8, 16)


def test_a_candidate_allocates_no_table():
    """Building a full-width candidate describes the module, it does not
    draw it: a 10.1 M-row full table (648 MB in f32) costs nothing here."""
    st = tplan.power_law_stats(10131227, 1.2, max_support=1000)
    cands = tplan.enumerate_candidates(0, st, DIM, dims=(4, 8, 16))
    full = [c for c in cands if c.spec.kind == "full" and c.dim == DIM]
    assert full and full[0].train_bytes == 10131227 * DIM * 4
    assert not any(isinstance(v, torch.Tensor) for c in cands for v in vars(c).values())


# ------------------------------------------------------------------ solver


@pytest.mark.parametrize("frac", [0.02, 0.05, 0.125, 0.5, 1.0])
@pytest.mark.parametrize("domain", ["train_f32", "serve_int8"])
@pytest.mark.parametrize("dims", [None, (4, 8, 16)])
def test_plans_and_solver_notes_are_equal(frac, domain, dims):
    stats = _stats(7)
    budget = int(jplan.full_table_bytes(SIZES, DIM, domain) * frac)
    want = jplan.build_plan(stats, DIM, budget, arch="t", bytes_domain=domain, dims=dims)
    got = tplan.build_plan(_port_stats(stats), DIM, budget, arch="t", bytes_domain=domain,
                           dims=dims)
    assert plan_differences(got, _as_port(want), 0.0) == []
    assert got.notes == want.notes and got.summary() == want.summary()
    wu = jplan.uniform_hash_plan(stats, DIM, budget, arch="u", bytes_domain=domain)
    tu = tplan.uniform_hash_plan(_port_stats(stats), DIM, budget, arch="u", bytes_domain=domain)
    assert plan_differences(tu, _as_port(wu), 0.0) == []


def test_infeasible_budget_is_refused_alike():
    stats = _stats(8)
    with pytest.raises(jplan.InfeasibleBudget):
        jplan.build_plan(stats, DIM, 10)
    with pytest.raises(tplan.InfeasibleBudget):
        tplan.build_plan(_port_stats(stats), DIM, 10)


def test_plan_differences_names_what_differs():
    stats = _port_stats(_stats(9))
    a = tplan.build_plan(stats, DIM, 200_000)
    b = tplan.MemoryPlan.from_json(a.to_json())
    assert plan_differences(a, b, 0.0) == []
    b.tables[1] = tplan.TablePlan(**{**b.tables[1].as_dict(), "ms": (), "entropies": (),
                                     "dim": 4, "quality": a.tables[1].quality + 1e-13})
    diffs = plan_differences(a, b, 1e-12)
    assert any("tables/1/dim" in d for d in diffs)
    assert not any("quality" in d for d in diffs)


# --------------------------------------------------------- the plan artifact


def test_plan_json_interchanges_both_ways(tmp_path):
    stats = _stats(10)
    jp = jplan.build_plan(stats, DIM, 300_000, arch="x", dims=(4, 8, 16))
    tp = tplan.build_plan(_port_stats(stats), DIM, 300_000, arch="x", dims=(4, 8, 16))
    from repro.dist.serve_placement import ServePlacement as JPlacement
    from repro_torch.dist.serve_placement import ServePlacement, SubTablePlacement
    placement = ServePlacement(2, 5, [SubTablePlacement(0, "table_0", "tables/0/table_0", 9,
                                                        10, 4, 54, "row_shard", True)])
    tp.annotate_placement(placement)
    jp.annotate_placement(JPlacement.from_dict(placement.as_dict()))
    # the port writes, the JAX package reads — and the reverse
    loaded_j = jplan.MemoryPlan.load(tp.save(str(tmp_path / "port.json")))
    loaded_t = tplan.MemoryPlan.load(jp.save(str(tmp_path / "jax.json")))
    assert loaded_j.to_json() == jp.to_json()
    assert loaded_t.to_json() == tp.to_json()
    assert loaded_t.table_dims == jp.table_dims and loaded_t.table_sizes == jp.table_sizes
    for i, n in enumerate(SIZES):
        assert loaded_t.spec_for(i, n, DIM).__dict__ == jp.spec_for(i, n, DIM).__dict__
        assert loaded_t.dim_for(i) == jp.dim_for(i)
    with pytest.raises(ValueError, match="regenerate"):
        loaded_t.spec_for(0, SIZES[0] + 1)
    with pytest.raises(ValueError, match="regenerate"):
        loaded_t.validate_sizes(SIZES[:-1])
    # the annotated placement reads back in either package
    assert loaded_t.serve_placement().as_dict() == placement.as_dict()
    assert loaded_j.serve_placement().as_dict() == placement.as_dict()
    assert tplan.PLAN_DIR == jplan.PLAN_DIR == os.path.join("artifacts", "plans")
    assert tplan.plan_path("a", 2 ** 20) == jplan.plan_path("a", 2 ** 20)


def test_config_takes_a_plan_or_its_path(tmp_path):
    cfg = dlrm_criteo.config(reduced=True)
    plan = tplan.build_plan(tplan.stats_from_criteo(
        CriteoSpec(table_sizes=cfg.table_sizes, zipf=1.5, noise=0.5), 2, 64),
        cfg.emb_dim, 200_000, arch="dlrm-criteo", dims=(4, 8, 16))
    path = plan.save(str(tmp_path / "p.json"))
    for arg in (plan, path):
        pcfg = dlrm_criteo.config(reduced=True, plan=arg)
        assert pcfg.embedding.to_json() == plan.to_json() and pcfg.emb_dim == plan.emb_dim
    # the JAX package's config takes the port's file, and builds the same widths
    jcfg = jdlrm_criteo.config(reduced=True, plan=path)
    assert jcfg.embedding.table_dims == plan.table_dims


# ------------------------------------------------------- reference_plans.json


def _sweep_stats(num_batches, batch_size):
    cfg = dlrm_criteo.config(reduced=True)
    return cfg, tplan.stats_from_criteo(CriteoSpec(table_sizes=cfg.table_sizes, zipf=1.5,
                                                   noise=0.5), num_batches, batch_size)


def test_reference_plans_sweep_holds_what_the_jax_planner_gives(reference):
    """``plan_bench``'s 8 reduced cells: the JAX planner on the port's stats
    gives the file's plans, and the port's ``_plan_cell`` solves the same."""
    sw = reference["sweep"]
    cfg, stats = _sweep_stats(sw["num_batches"], sw["batch_size"])
    jstats = [jplan.FeatureStats(size=s.size, ids=s.ids, probs=s.probs) for s in stats]
    by_arch = {}
    for cell in sw["cells"]:
        frac, arch = cell["budget_frac"], cell["arch"]
        budget = int(jplan.full_table_bytes(cfg.table_sizes, cfg.emb_dim) * frac)
        assert budget == cell["budget_bytes"]
        uniform = jplan.uniform_hash_plan(jstats, cfg.emb_dim, budget, arch=arch)
        solved = {"uniform": uniform,
                  "plan": jplan.build_plan(jstats, cfg.emb_dim, budget, arch=arch,
                                           baseline=uniform),
                  "mixed": jplan.build_plan(jstats, cfg.emb_dim, budget, arch=f"{arch}-mixed",
                                            baseline=uniform, dims=jplan.dim_ladder(16))}
        for key, p in solved.items():
            stored = tplan.MemoryPlan.from_json(json.dumps(cell[key]))
            assert plan_differences(_as_port(p), stored, 0.0) == []
        if arch not in by_arch:
            by_arch[arch] = True
            row = tbench._plan_cell(arch, cfg, stats, frac, save=False)
            assert row["quality"] == pytest.approx(cell["plan"]["quality"], abs=1e-12)
            assert row["mixed_quality"] == pytest.approx(cell["mixed"]["quality"], abs=1e-12)
            assert row["plan_bytes"] == cell["plan"]["total_bytes"]
    assert len(sw["cells"]) == 8


def test_reference_plans_full_width_plan_is_the_ports(reference):
    """The full-width ``[plan]`` plan (DLRM-Criteo, 24 x 512 CPU-drawn
    batches, 0.125 x the f32 tables, widths {4, 8, 16}): the port's
    ``plan_for_config`` equals the file's plan, which the JAX planner gives
    on the same stats — 22 full tables and 4 QR pairs, every one a table
    the grouped K4 takes."""
    fw = reference["full_width"]
    cfg = dlrm_criteo.config(reduced=False)
    budget = int(tplan.full_table_bytes(cfg.table_sizes, cfg.emb_dim) * fw["budget_frac"])
    assert budget == fw["budget_bytes"]
    plan = tplan.plan_for_config(cfg, budget, num_batches=fw["num_batches"],
                                 batch_size=fw["batch_size"], dims=tplan.dim_ladder(16))
    stored = tplan.MemoryPlan.from_json(json.dumps(fw["plan"]))
    assert plan_differences(plan, stored, 1e-12) == []
    s = plan.summary()
    assert s["kinds"] == {"full": 22, "qr": 4} and s["dims"] == {"4": 7, "8": 11, "16": 8}
    assert plan.total_bytes == 258_118_192
    assert sum(t.serve_bytes_int8 for t in plan.tables) == 76_700_011
    # the JAX planner on the very same stats
    stats = tplan.stats_from_criteo(CriteoSpec(table_sizes=cfg.table_sizes, zipf=1.5,
                                               noise=0.5), fw["num_batches"], fw["batch_size"])
    jstats = [jplan.FeatureStats(size=x.size, ids=x.ids, probs=x.probs) for x in stats]
    want = jplan.build_plan(jstats, cfg.emb_dim, budget, arch=cfg.name,
                            dims=jplan.dim_ladder(16))
    assert plan_differences(plan, _as_port(want), 0.0) == []


def test_reference_stream_reproduces_the_greedy_solvers_fault(reference):
    """On the JAX package's own stream (6 batches of 256, reduced
    DLRM-Criteo), the greedy walk's mixed-width plan falls below the
    uniform-width one at the 0.05 budget: 0.99997813 vs 0.99997874.  The
    port's plans on those stats equal the reference's, fault included, and
    ``plan_bench``'s check names it as the reference's does."""
    rs = reference["reference_stream"]
    cfg = jdlrm_criteo.config(reduced=True)
    jstats = jplan.stats_from_criteo(JCriteoSpec(table_sizes=cfg.table_sizes, zipf=1.5,
                                                 noise=0.5), rs["num_batches"], rs["batch_size"])
    tstats = _port_stats(jstats)
    rows = []
    for cell in rs["cells"]:
        budget = cell["budget_bytes"]
        tu = tplan.uniform_hash_plan(tstats, cfg.emb_dim, budget, arch=cell["arch"])
        tp = tplan.build_plan(tstats, cfg.emb_dim, budget, arch=cell["arch"], baseline=tu)
        tm = tplan.build_plan(tstats, cfg.emb_dim, budget, arch=f"{cell['arch']}-mixed",
                              baseline=tu, dims=tplan.dim_ladder(16))
        for key, p in (("uniform", tu), ("plan", tp), ("mixed", tm)):
            assert plan_differences(p, tplan.MemoryPlan.from_json(json.dumps(cell[key])),
                                    1e-12) == []
        rows.append({"arch": cell["arch"], "budget_frac": cell["budget_frac"],
                     "budget_bytes": budget, "plan_bytes": tp.total_bytes,
                     "built_bytes": tp.total_bytes, "quality": tp.quality,
                     "uniform_quality": tu.quality, "mixed_bytes": tm.total_bytes,
                     "mixed_built_bytes_ok": True, "mixed_quality": tm.quality,
                     "compositional_complementary": True})
    q = {r["budget_frac"]: (round(r["mixed_quality"], 8), round(r["quality"], 8)) for r in rows}
    assert q[0.05] == (0.99997813, 0.99997874)
    assert q[0.125][0] > q[0.125][1]
    report = {"rows": rows}
    from benchmarks import plan_bench as jbench
    assert tbench.check(report) == jbench.check(report)
    assert [name for name, _ in tbench.check(report)] == ["dlrm-criteo/b0.05"]


# ------------------------------------------------------------------ plan_bench


def test_plan_bench_checks_summary_and_rows_match_the_reference():
    from benchmarks import plan_bench as jbench
    assert (tbench.BUDGET_FRACS, tbench.MIXED_STRICT_FRAC, tbench.ARCHS) \
        == (jbench.BUDGET_FRACS, jbench.MIXED_STRICT_FRAC, jbench.ARCHS)
    row = {"arch": "a", "budget_frac": 0.125, "budget_bytes": 10, "plan_bytes": 11,
           "built_bytes": 9, "quality": 0.5, "uniform_quality": 0.6, "mixed_bytes": 12,
           "mixed_built_bytes_ok": False, "mixed_quality": 0.4,
           "compositional_complementary": False, "parked": 1, "mixed_parked": 2}
    report = {"rows": [row, dict(row, budget_frac=0.25, quality=0.4, mixed_quality=0.3)],
              "archs": ["a"], "budget_fracs": [0.125, 0.25]}
    assert tbench.check(report) == jbench.check(report)
    assert len(tbench.check(report)) >= 8
    want, got = jbench.summarize(report), tbench.summarize(report)
    assert got["source"].startswith("artifacts/bench_torch")
    assert {k: v for k, v in got.items() if k != "source"} \
        == {k: v for k, v in want.items() if k != "source"}
    rows = tbench.rows(device="cpu")
    assert [name for name, _, _ in rows] == ["plan/dlrm-criteo/b0.05", "plan/dlrm-criteo/b0.25"]


def test_plan_bench_main_writes_under_bench_torch_only(tmp_path, monkeypatch, capsys):
    """A short run end to end: its CSV rows and report land under
    ``artifacts/bench_torch/``, the repo-root ``BENCH_plan.json`` (the
    reference's) is not written; on this short stream every check passes."""
    monkeypatch.chdir(tmp_path)
    code = tbench.main(["--stats-batches", "2", "--batch-size", "128", "--no-save-plans"])
    out = capsys.readouterr().out
    assert code == 0, out
    assert out.count("plan/dlrm-criteo/b") == 4 and out.count("plan/dcn-criteo/b") == 4
    assert (tmp_path / "artifacts" / "bench_torch" / "BENCH_plan.json").exists()
    assert (tmp_path / "artifacts" / "bench_torch" / "BENCH_plan_summary.json").exists()
    assert not (tmp_path / "BENCH_plan.json").exists()


# ------------------------------------------------------------------ plan_cli


def _args(**kw):
    base = dict(arch="dlrm-criteo", plan=None, plan_budget_mb=None, plan_dims=None)
    return type("Args", (), dict(base, **kw))()


@pytest.mark.parametrize("kw, message", [
    (dict(plan_dims="mixed"), "--plan-dims needs --plan-budget-mb"),
    (dict(plan="p.json", plan_budget_mb=1.0), "mutually exclusive"),
    (dict(plan="p.json", plan_dims="mixed"), "--plan-dims only applies"),
])
def test_plan_cli_flag_errors_match_the_reference(kw, message):
    for cli, mod in ((tplan_cli, dlrm_criteo), (jplan_cli, jdlrm_criteo)):
        with pytest.raises(SystemExit, match=message):
            cli.resolve_plan_args(mod, _args(**kw))
    lm = type(sys)("lm_arch")
    lm.FAMILY = "lm"
    with pytest.raises(SystemExit, match="not a rec-family arch"):
        tplan_cli.resolve_plan_args(lm, _args(arch="lm", plan_budget_mb=1.0))
    assert tplan_cli.resolve_plan_args(dlrm_criteo, _args()) is None


def test_plan_cli_solves_saves_and_loads(tmp_path, monkeypatch, capsys):
    import argparse

    monkeypatch.chdir(tmp_path)
    ap = argparse.ArgumentParser()
    tplan_cli.add_plan_args(ap)
    args = ap.parse_args(["--plan-budget-mb", "0.25", "--plan-dims", "4,16"])
    args.arch = "dlrm-criteo"
    plan = tplan_cli.resolve_plan_args(dlrm_criteo, args)
    assert set(plan.table_dims) <= {4, 16} and plan.notes["dim_ladder"] == [4, 16]
    path = tmp_path / tplan.plan_path("dlrm-criteo", int(0.25 * 2 ** 20))
    assert path.exists()
    args = ap.parse_args(["--plan", str(path)])
    args.arch = "dlrm-criteo"
    again = tplan_cli.resolve_plan_args(dlrm_criteo, args)
    assert again.to_json() == plan.to_json()
    assert "plan: loaded" in capsys.readouterr().out

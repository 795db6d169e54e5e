"""The port's static analyzer (``repro_torch.analysis``) held against the
JAX package's (``repro.analysis``), on the CPU.

* Layer 1: the port's six AST rules find exactly what the reference's
  find — the same ``(rule, path, line, suppressed)`` set — on the
  reference's seeded fixtures and on ``src/repro`` and ``benchmarks``;
  each torch-spelling fixture (``tests/analysis_fixtures/torch/``) trips
  its rule at its line; the port's own tree is clean; suppressions
  round-trip; ``--layer 1`` imports neither torch nor the JAX package.
* INJ-001's certificates equal ``repro.analysis.injectivity.certify_plan``'s
  table by table on the port's 16 sweep plans, the seeded bad plan and the
  full-width plan.
* ACC-002 on the CPU finds nothing on the eight programs, and trips on a
  seeded bf16 ``torch.sum`` (dispatched dtype) and a seeded bf16 running
  sum (numerics).
* JIT-002's signature counts and buckets equal the JAX engine's
  ``compile_count()`` on the same stream and converted parameters.
* The full CLI run on the CPU exits 0 with the ten ids, and its report
  renders through ``benchmarks/summary_md.py``.

WIRE-001's world of ranks is ``tests/test_torch_analysis_world.py``.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.analysis import injectivity as jax_inj
from repro.analysis import load_passes as jax_load_passes
from repro.analysis.findings import apply_suppressions as jax_apply
from repro.analysis.registry import Context as JaxContext
from repro.plan.memory_plan import MemoryPlan as JaxPlan
from repro_torch.analysis import injectivity, load_passes
from repro_torch.analysis.acc_audit import RTOL, audit_program
from repro_torch.analysis.cli import run
from repro_torch.analysis.findings import Finding, apply_suppressions, format_findings
from repro_torch.analysis.findings import suppressions_for
from repro_torch.analysis.programs import (AUDIT_B, AUDIT_D, AUDIT_L, KernelProgram, Oracle,
                                           kernel_programs)
from repro_torch.analysis.registry import Context

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join("tests", "analysis_fixtures")
TORCH_FIXTURES = os.path.join(FIXTURES, "torch")
# every seeded fixture of the reference: the files outside torch/
REFERENCE_FIXTURES = sorted(
    os.path.relpath(os.path.join(d, f), REPO)
    for d, _, fs in os.walk(os.path.join(REPO, FIXTURES))
    if "torch" not in os.path.relpath(d, os.path.join(REPO, FIXTURES)).split(os.sep)
    for f in fs if f.endswith(".py"))
IDS = {"ACC-001", "JIT-001", "OBS-001", "DET-001", "EXC-001", "DON-001",
       "ACC-002", "WIRE-001", "JIT-002", "INJ-001"}
FULL_WIDTH_PLAN = os.path.join(REPO, "src", "repro_torch", "benchmarks", "reference_plans.json")


def _layer1(load, context, apply, paths):
    passes = load("1")
    ctx = context(root=REPO, paths=paths)
    found = []
    for info in passes.values():
        if info.layer == 1:
            found += info.fn(ctx)
    return apply(found, ctx.sources())


def _port_layer1(paths):
    return _layer1(load_passes, Context, apply_suppressions, paths)


def _keys(findings):
    return {(f.rule, f.path, f.line, f.suppressed) for f in findings}


# ------------------------------------------------------------- layer 1


def test_reference_fixtures_are_found():
    assert len(REFERENCE_FIXTURES) == 7 and not any("torch" in p for p in REFERENCE_FIXTURES)


@pytest.mark.parametrize("paths", [[p] for p in REFERENCE_FIXTURES]
                         + [["src/repro"], ["benchmarks"]], ids=lambda p: p[0])
def test_layer1_parity_with_the_reference(paths):
    want = _keys(_layer1(jax_load_passes, JaxContext, jax_apply, paths))
    got = _keys(_port_layer1(paths))
    assert got == want


@pytest.mark.parametrize("fixture,rule,line", [
    ("kernels/bad_accum.py", "ACC-001", 9),
    ("kernels/bad_accum.py", "ACC-001", 13),
    ("bad_jit.py", "JIT-001", 11),
    ("bad_jit.py", "JIT-001", 17),
    ("bad_det.py", "DET-001", 13),
    ("bad_det.py", "DET-001", 18),
])
def test_torch_fixture_trips_rule(fixture, rule, line):
    found = _port_layer1([os.path.join(TORCH_FIXTURES, fixture)])
    assert any(f.rule == rule and f.line == line and not f.suppressed for f in found), found


def test_torch_fixtures_trip_nothing_else():
    """The f32 forms (``dtype=``, ``.float()``, ``.to(torch.float32)``) and
    the draw with ``generator=`` are clean: only the seeded lines trip."""
    found = _port_layer1([TORCH_FIXTURES])
    assert {(os.path.basename(f.path), f.line) for f in found} == {
        ("bad_accum.py", 9), ("bad_accum.py", 13), ("bad_jit.py", 11), ("bad_jit.py", 17),
        ("bad_det.py", 13), ("bad_det.py", 18)}


def test_port_tree_layer1_no_live_findings():
    found = _port_layer1(None)     # the default scan: the port's own tree
    assert [f for f in found if not f.suppressed] == []
    rels = {f for f in Context(root=REPO).sources()}
    assert "chip_smoke.py" in rels and "tests/test_torch_analysis.py" in rels
    assert not any(r.startswith(("src/repro/", "tests/analysis_fixtures")) for r in rels)


def test_noqa_roundtrip():
    found = _port_layer1([os.path.join(FIXTURES, "noqa_ok.py")])
    assert len(found) == 1 and found[0].suppressed and found[0].rule == "JIT-001"
    text = ("x = 1\n"
            "y = f()   # repro: noqa[ACC-001, JIT-001] why\n"
            "z = g()   # repro: noqa\n")
    sup = suppressions_for(text)
    assert sup[2] == frozenset({"ACC-001", "JIT-001"})
    assert sup[3] is None and 1 not in sup


def test_layer1_imports_neither_torch_nor_the_reference():
    code = ("import sys\n"
            "from repro_torch.analysis.cli import run\n"
            "rc = run(['--layer', '1', '--root', sys.argv[1]])\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'repro'))\n"
            "assert rc == 0 and not bad, (rc, bad[:5])\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code, REPO], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_list_shows_the_ten_ids(capsys):
    assert run(["--list"]) == 0
    shown = {line.split()[0] for line in capsys.readouterr().out.splitlines()}
    assert shown == IDS


def test_formats_and_exit_codes(tmp_path, capsys):
    fs = [Finding(rule="ACC-001", path="a.py", line=3, message="m"),
          Finding(rule="JIT-001", path="b.py", line=7, message="n", suppressed=True)]
    human = format_findings(fs, "human")
    assert "a.py:3" in human and "[suppressed]" in human
    gh = format_findings(fs, "github")
    assert "::error file=a.py,line=3,title=ACC-001::" in gh and "::notice file=b.py" in gh
    rep = json.loads(format_findings(fs, "json", root=REPO))
    assert rep["counts"] == {"total": 2, "unsuppressed": 1, "suppressed": 1}
    out = tmp_path / "r.json"
    assert run(["--layer", "1", "--root", REPO, "--paths",
                os.path.join(FIXTURES, "bad_except.py"), "--out", str(out)]) == 1
    assert json.loads(out.read_text())["ok"] is False
    # selecting a rule the fixture does not violate: a clean exit
    assert run(["--layer", "1", "--root", REPO, "--select", "EXC-001", "--paths",
                os.path.join(TORCH_FIXTURES, "bad_jit.py")]) == 0
    capsys.readouterr()


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(["--select", "JIT-002"])


# -------------------------------------------------------------- INJ-001


def _cert_keys(row):
    return [(c["feature"], c["method"], c["exact"], c["injective"], c["required"])
            for c in row["certificates"]]


def _plan_files(tmp_path):
    paths = []
    for anchor, plan in injectivity.sweep_plans():
        paths.append(plan.save(str(tmp_path / (anchor.rsplit("/", 1)[1] + ".json"))))
    assert len(paths) == 16
    full = json.load(open(FULL_WIDTH_PLAN))["full_width"]["plan"]
    (tmp_path / "full_width.json").write_text(json.dumps(full))
    return paths + [os.path.join(REPO, FIXTURES, "bad_plan.json"),
                    str(tmp_path / "full_width.json")]


def test_certificates_equal_the_reference(tmp_path):
    from repro_torch.plan.memory_plan import MemoryPlan
    for path in _plan_files(tmp_path):
        fs, row = injectivity.certify_plan(MemoryPlan.load(path), path)
        jfs, jrow = jax_inj.certify_plan(JaxPlan.load(path), path)
        assert _cert_keys(row) == _cert_keys(jrow), path
        assert [f.message for f in fs] == [f.message for f in jfs], path
    assert row["tables"] == 26 and row["exact"] == 26 and fs == []
    assert sum(c["size"] for c in row["certificates"]) == 33_762_577


def test_certifier_structural_families_exact():
    from repro_torch.core.partitions import (crt_partitions, generalized_qr_partitions,
                                             naive_partition, qr_partitions)
    for parts, size, method in [(naive_partition(97), 97, "mixed-radix"),
                                (qr_partitions(1000, 32), 1000, "quotient-remainder"),
                                (generalized_qr_partitions(500, (8, 8, 8)), 500, "mixed-radix"),
                                (crt_partitions(90, (9, 11)), 90, "crt")]:
        cert = injectivity.certify_partitions(parts, size)
        assert cert.injective and cert.exact and cert.method == method, cert


def test_certifier_matches_the_reference_on_random_families():
    from repro.core.partitions import ExplicitPartition as JExplicit
    from repro_torch.core.partitions import ExplicitPartition, is_complementary
    rng = np.random.default_rng(0)
    for _ in range(20):
        size = int(rng.integers(20, 200))
        tables = [rng.integers(0, b, size) for b in rng.integers(2, size + 1,
                                                                 int(rng.integers(1, 4)))]
        parts = [ExplicitPartition(size=size, num_buckets=int(t.max()) + 1, table=t)
                 for t in tables]
        cert = injectivity.certify_partitions(parts, size)
        jcert = jax_inj.certify_partitions(
            [JExplicit(size=size, num_buckets=int(t.max()) + 1, table=t) for t in tables], size)
        assert dataclasses.astuple(cert) == dataclasses.astuple(jcert)
        assert cert.exact and cert.injective == is_complementary(parts, size)


def test_certifier_sampling_fallback_is_honest():
    from repro_torch.core.partitions import ExplicitPartition, RemainderPartition
    size = injectivity.COMPLEMENTARY_CHECK_MAX + 50_000
    perm = np.random.default_rng(1).permutation(size)
    cert = injectivity.certify_partitions(
        [ExplicitPartition(size=size, num_buckets=size, table=perm)], size)
    assert cert.injective and not cert.exact and cert.method == "sampled"
    cert = injectivity.certify_partitions(
        [RemainderPartition(size=size, num_buckets=m, m=m) for m in (500, 502)], size)
    assert not cert.injective and cert.exact and cert.method == "sampled"


def test_hash_tables_are_lossy_by_design():
    from repro_torch.plan.memory_plan import TablePlan
    t = TablePlan(feature=0, num_categories=100, kind="hash", num_collisions=4)
    required, cert, _ = injectivity.certify_table(t, 16)
    assert not required and not cert.injective


# -------------------------------------------------------------- ACC-002


@pytest.mark.parametrize("prog", kernel_programs(), ids=lambda p: p.name)
def test_acc_programs_clean_on_the_cpu(prog):
    findings, row = audit_program(prog, "cpu")
    assert findings == []
    assert row["program_rel_err"] <= RTOL
    if prog.audit is not None:
        assert row["audit_rel_err"] <= RTOL < row["control_rel_err"]


def _sum_terms(x):
    x = x.to(torch.float64)
    return Oracle(x.sum(1), x.abs().sum(1), x, 1)


def _bag(device):
    rng = np.random.default_rng(0)
    x = np.abs(rng.normal(size=(AUDIT_B, AUDIT_L, AUDIT_D))) + 0.5
    return (torch.as_tensor(x).to(device, torch.bfloat16),)


def test_acc_seeded_bf16_sum_trips_the_dispatch_check():
    prog = KernelProgram("seeded.bf16_sum", lambda d: (lambda x: torch.sum(x, dim=1), _bag(d)),
                         _sum_terms)
    findings, _ = audit_program(prog, "cpu")
    assert len(findings) == 1 and "sum accumulates in torch.bfloat16" in findings[0].message
    assert findings[0].path == "analysis://acc/seeded.bf16_sum[cpu]"
    ok = KernelProgram("seeded.f32_sum", lambda d: (
        lambda x: torch.sum(x, dim=1, dtype=torch.float32), _bag(d)), _sum_terms)
    assert audit_program(ok, "cpu")[0] == []


def test_acc_seeded_running_sum_trips_the_numeric_check():
    """A bf16 running sum dispatches only adds, which the dtype check does
    not audit — as a kernel is opaque to it; the f64 oracle catches it."""
    def running(x):
        acc = torch.zeros_like(x[:, 0])
        for lane in range(x.shape[1]):
            acc = acc + x[:, lane]
        return acc
    prog = KernelProgram("seeded.running", lambda d: (running, _bag(d)), _sum_terms)
    findings, row = audit_program(prog, "cpu")
    assert len(findings) == 1 and "departs from the f64 oracle" in findings[0].message
    assert row["program_rel_err"] > RTOL


# -------------------------------------------------------------- JIT-002


def test_jit_counts_equal_the_jax_engine():
    from repro.analysis.jit_audit import _build_engine as jax_engine
    from repro.analysis.jit_audit import replay_and_audit as jax_replay
    from repro_torch.analysis.jit_audit import replay_and_audit, small_config
    from repro_torch.convert import params_from_jax
    from repro_torch.serve.recsys import RecsysEngine
    jeng = jax_engine()
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params), "cpu")
    jfound, jtel = jax_replay(jeng)
    found, tel = replay_and_audit(RecsysEngine(small_config(), params, max_batch=8,
                                               device="cpu"))
    assert found == jfound == []
    assert tel["first_pass"]["per_program"] == jtel["first_pass"]["per_program"]
    assert tel["replay"] == jtel["replay"] == tel["first_pass"]
    assert [tuple(b) for b in tel["buckets_seen"]] == [tuple(b) for b in jtel["buckets_seen"]]
    assert tel["bounds"] == jtel["bounds"]


# ------------------------------------------------------------- the CLI


def test_cli_full_run_on_the_cpu_exits_zero_and_renders(tmp_path):
    out = tmp_path / "report.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--device", "cpu",
                           "--format", "github", "--out", str(out)],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rep = json.loads(out.read_text())
    assert rep["ok"] is True and {p["id"] for p in rep["passes"]} == IDS
    notes = {p["id"]: p["notes"] for p in rep["passes"]}
    assert len(notes["ACC-002"]["programs"]) == 8
    assert len(notes["WIRE-001"]["exchanges"]) == 8 and notes["WIRE-001"]["world"] == 8
    assert notes["INJ-001"]["tables_certified"] >= 160
    md = subprocess.run([sys.executable, "-m", "benchmarks.summary_md", "--analysis",
                         str(out), "--no-bench"], cwd=REPO, capture_output=True, text=True,
                        timeout=120)
    assert md.returncode == 0, md.stderr
    assert "**PASS**" in md.stdout and all(f"| {i} (" in md.stdout for i in IDS)

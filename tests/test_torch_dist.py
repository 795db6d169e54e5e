"""The port's ``dist`` package, its DP state, its Trainer wire counters,
the training launcher and ``dist_bench``, held against the JAX package on
the CPU.  (The gloo world of 8 against the reference's 8-device
``shard_map`` is ``tests/test_torch_dist_world.py``.)

* ``policy``: every leaf's mode equal to the reference's on the DLRM and
  DCN trees (uniform and planned, mixed width);
* ``accounting``: the reference's floats exactly, every policy, n ∈ {1, 2,
  4, 8}; the FSDP and sharded-serving prices of trees with nothing to
  scatter or shard (the full prices: ``tests/test_torch_fsdp.py``,
  ``tests/test_torch_serve_dist.py``);
* ``quantize_int8`` and local ``ef_psum_grads`` (``group=None``)
  bit-equal to the reference's, residual state included, over repeated
  calls;
* a world of one: the DP step equals ``make_train_step``;
* ``Trainer(step_wire=)``: the registry's per-leaf wire counters equal the
  reference Trainer's;
* ``convert`` carries a DP state's ``err`` tree;
* the launcher on the CPU, alone and under ``torchrun`` with two ranks;
  ``dist_bench`` in a gloo world of 8.
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import dcn_criteo as jdcn
from repro.configs import dlrm_criteo as jdlrm
from repro.dist import AUTO as JAUTO
from repro.dist import accounting as jacc
from repro.dist import compress as jcomp
from repro.dist import policy as jpolicy
from repro.plan import MemoryPlan as JPlan
from repro.train import loop as jloop
from repro_torch import obs as tobs
from repro_torch import tree
from repro_torch.configs import dcn_criteo, dlrm_criteo
from repro_torch.convert import state_from_jax, state_to_numpy
from repro_torch.dist import AUTO, CompressionPolicy, accounting, compress, policy, resolve_policy
from repro_torch.dist import world as tworld
from repro_torch.plan import dim_ladder, plan_for_config
from repro_torch.train import loop as tloop

ROOT = Path(__file__).resolve().parents[1]
POLICIES = ("none", "bf16", "int8", "auto")
WORLDS = (1, 2, 4, 8)


def _planned(mod):
    cfg = mod.config(reduced=True)
    return plan_for_config(cfg, 200_000, arch=mod.ARCH, dims=dim_ladder(cfg.emb_dim))


@functools.lru_cache(maxsize=None)
def _trees(net, planned):
    """The port's parameter tree (drawn on the CPU) and the reference's
    (shapes only) for one reduced config; built once per module (the tests
    only read them)."""
    mod, jmod = {"dlrm": (dlrm_criteo, jdlrm), "dcn": (dcn_criteo, jdcn)}[net]
    if planned:
        plan = _planned(mod)
        cfg, jcfg = mod.config(reduced=True, plan=plan), jmod.config(
            reduced=True, plan=JPlan.from_json(plan.to_json()))
    else:
        cfg, jcfg = mod.config(reduced=True), jmod.config(reduced=True)
    tparams = mod.api(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    jparams = jax.eval_shape(jmod.api(jcfg).init, jax.random.PRNGKey(0))
    return tparams, jparams


def _jpol(name):
    return JAUTO if name == "auto" else name


def _tpol(name):
    return AUTO if name == "auto" else name


@pytest.mark.parametrize("planned", [False, True], ids=["uniform", "planned"])
@pytest.mark.parametrize("net", ["dlrm", "dcn"])
def test_policy_modes_equal_reference(net, planned):
    tparams, jparams = _trees(net, planned)
    assert AUTO.modes(tparams) == JAUTO.modes(jparams)
    assert set(AUTO.modes(tparams)) == {"none", "bf16", "int8"}
    custom = dict(rules=((r"(^|/)tables?(/|$)", "bf16"),), default="int8",
                  min_compress_elems=100, small_mode="bf16")
    assert (CompressionPolicy(**custom).modes(tparams)
            == jpolicy.CompressionPolicy(**custom).modes(jparams))
    assert tree.leaves(AUTO.tree(tparams)) == AUTO.modes(tparams)


def test_policy_resolution_and_errors():
    assert resolve_policy("auto") is AUTO
    assert resolve_policy("int8") == "int8"
    pol = CompressionPolicy(default="none")
    assert resolve_policy(pol) is pol
    with pytest.raises(ValueError, match="unknown compression policy"):
        resolve_policy("fp4")
    with pytest.raises(ValueError, match="unknown compression mode"):
        CompressionPolicy(default="fp4")
    assert policy.POLICY_RULES == jpolicy.POLICY_RULES


@pytest.mark.parametrize("planned", [False, True], ids=["uniform", "planned"])
@pytest.mark.parametrize("pol", POLICIES)
def test_accounting_equals_reference(pol, planned):
    tparams, jparams = _trees("dlrm", planned)
    for n in WORLDS:
        got = accounting.grad_wire_bytes(tparams, _tpol(pol), n)
        want = jacc.grad_wire_bytes(jparams, _jpol(pol), n)
        assert got == want
        got = accounting.dp_step_wire_bytes(tparams, _tpol(pol), n, scalar_allreduces=3)
        assert got == jacc.dp_step_wire_bytes(jparams, _jpol(pol), n, scalar_allreduces=3)
        got = accounting.grad_wire_bytes(tparams, _tpol(pol), n, pattern="reduce_scatter")
        assert got == jacc.grad_wire_bytes(jparams, _jpol(pol), n, pattern="reduce_scatter")


def test_accounting_closed_forms_and_refusals():
    for n in WORLDS:
        for nbytes in (0, 1, 12, 1000, 3 * 2 ** 20 + 7):
            for name in ("ring_all_reduce_bytes", "ring_all_gather_bytes",
                         "ring_reduce_scatter_bytes", "ring_all_to_all_bytes"):
                assert getattr(accounting, name)(nbytes, n) == getattr(jacc, name)(nbytes, n)
        for mode in ("none", "bf16", "int8"):
            for e in (0, 1, 7, 9, 4096, 100_003):
                for pattern in ("all_reduce", "reduce_scatter"):
                    assert (accounting.leaf_reduce_bytes(mode, e, n, pattern=pattern)
                            == jacc.leaf_reduce_bytes(mode, e, n, pattern=pattern))
        for q in (True, False):
            assert (accounting.serve_exchange_wire_bytes(64, 16, n, quantized=q)
                    == jacc.serve_exchange_wire_bytes(64, 16, n, quantized=q))
    with pytest.raises(ValueError, match="unknown compression mode"):
        accounting.leaf_reduce_bytes("fp4", 10, 2)
    from repro_torch.dist.serve_placement import ServePlacement
    from repro_torch.optim.optimizers import adagrad
    empty = accounting.fsdp_step_wire_bytes({}, adagrad(1e-2), 4, "none", scalar_allreduces=1)
    assert (empty["total_bytes"], empty["n_leaves"]) == (accounting.ring_all_reduce_bytes(4.0, 4),
                                                         0)
    assert accounting.serve_wave_wire_bytes(ServePlacement(4, 1), 8, 4)["total_bytes"] == 0


def _np_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": (rng.standard_normal((64, 16)) * 1e-3).astype(np.float32),
            "b": [(rng.standard_normal((9,)) * 1e-2).astype(np.float32),
                  (rng.standard_normal((3000, 2))).astype(np.float32)],
            "c": np.zeros((5, 5), np.float32), "d": np.full((7,), -2.5, np.float32)}


def test_quantize_int8_bit_equal_to_reference():
    for x in tree.leaves(_np_tree(0)) + [np.float32([1e-30, -3e-38, 0.0])]:
        jq, js = jcomp.quantize_int8(jnp.asarray(x))
        tq, ts = compress.quantize_int8(torch.from_numpy(x))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert tq.dtype == torch.int8
        assert ts.numpy().tobytes() == np.asarray(js, np.float32).tobytes()


@pytest.mark.parametrize("mode", ["none", "bf16", "int8", "auto", "mixed"])
def test_local_ef_psum_grads_bit_equal_to_reference(mode):
    """Ten calls with the residual carried, on changing gradients: outputs
    and residuals bit-equal to the reference's uncompiled call."""
    g0 = _np_tree(1)
    mixed = {"a": "int8", "b": ["none", "bf16"], "c": "int8", "d": "bf16"}
    tmode = AUTO if mode == "auto" else mixed if mode == "mixed" else mode
    jmode = JAUTO if mode == "auto" else mixed if mode == "mixed" else mode
    je = jcomp.init_error_state(jax.tree.map(jnp.asarray, g0), jmode)
    te = compress.init_error_state(tree.tree_map(torch.from_numpy, g0), tmode)
    for a, b in zip(jax.tree.leaves(je), tree.leaves(te)):
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32
    for step in range(10):
        g = _np_tree(100 + step)
        jo, je = jcomp.ef_psum_grads(jax.tree.map(jnp.asarray, g), je, axis_name=None,
                                     mode=jmode)
        to, te = compress.ef_psum_grads(tree.tree_map(torch.from_numpy, g), te, group=None,
                                        mode=tmode)
        for a, b in zip(jax.tree.leaves(jo) + jax.tree.leaves(je),
                        tree.leaves(to) + tree.leaves(te)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_ef_rejects_unknown_mode_and_mismatched_state():
    g = {"w": torch.ones(4)}
    with pytest.raises(ValueError, match="unknown compression mode"):
        compress.ef_psum_grads(g, compress.init_error_state(g), mode="fp4")
    with pytest.raises(ValueError, match="error state does not match"):
        compress.ef_psum_grads(g, [torch.zeros(4), torch.zeros(4)])
    with pytest.raises(ValueError, match="mode tree does not match"):
        compress.resolve_modes(g, ["int8", "bf16"])


def _small():
    """A small DLRM (reference and port configs) and a CPU-drawn batch fn."""
    from repro.core import EmbeddingSpec as JSpec
    from repro.models import dlrm as jm
    from repro_torch.core import EmbeddingSpec as TSpec
    from repro_torch.data.criteo import CriteoSpec, batch_at
    from repro_torch.models import dlrm as tm
    sizes = (100, 5000, 33)
    kw = dict(table_sizes=sizes, emb_dim=8, bottom_mlp=(32, 8), top_mlp=(32, 16))
    spec = dict(kind="qr", num_collisions=4, threshold=50)
    jcfg, tcfg = jm.DLRMConfig(embedding=JSpec(**spec), **kw), tm.DLRMConfig(
        embedding=TSpec(**spec), **kw)
    cspec = CriteoSpec(table_sizes=sizes)

    def batches(s, b=32):
        return batch_at(0, s, b, cspec, device="cpu")

    return jm, tm, jcfg, tcfg, batches


def test_dp_step_in_a_world_of_one_equals_the_plain_step():
    """At n = 1 the "none" reduction is the identity: the DP step's
    parameters, optimizer state and loss equal ``make_train_step``'s bit
    for bit; a compressed policy's step runs (with ``clip_norm``)."""
    _, tm, _, tcfg, batches = _small()
    opt = dlrm_criteo.api(dlrm_criteo.config(reduced=True), device="cpu").optimizer
    params = tm.dlrm_init(tcfg, torch.Generator().manual_seed(0), "cpu")

    def loss_fn(p, b):
        return tm.dlrm_loss_fn(p, b, tcfg)

    tworld.local("gloo")
    try:
        plain = tloop.init_state(params, opt)
        dp = tloop.init_dp_state(params, opt, compress="none")
        assert all(e.shape == () for e in tree.leaves(dp["err"]))
        step, dstep = (tloop.make_train_step(loss_fn, opt),
                       tloop.make_dp_train_step(loss_fn, opt, compress="none"))
        for s in range(3):
            plain, pm = step(plain, batches(s))
            dp, dm = dstep(dp, batches(s))
            assert float(pm["loss"]) == float(dm["loss"])
            assert set(dm) == {"loss", "bce", "acc"}
        for a, b in zip(tree.leaves(plain["params"]) + tree.leaves(plain["opt"]),
                        tree.leaves(dp["params"]) + tree.leaves(dp["opt"])):
            assert torch.equal(a, b)
        assert int(dp["step"]) == 3
        st = tloop.init_dp_state(params, opt, compress="auto")
        st, m = tloop.make_dp_train_step(loss_fn, opt, compress="auto", clip_norm=1.0)(
            st, batches(0))
        assert "grad_norm" in m and torch.isfinite(m["loss"])
    finally:
        torch.distributed.destroy_process_group()


def test_trainer_step_wire_counters_equal_reference():
    """Per-leaf ``train_wire_bytes_total`` counters, and the ``_other``
    remainder of a report with only a total, equal the reference
    Trainer's registry after the same number of steps."""
    jm, tm, jcfg, tcfg, batches = _small()
    from repro.data.criteo import CriteoSpec as JCriteoSpec
    from repro.data.criteo import batch_at as jbatch_at
    from repro.optim.optimizers import adagrad as jadagrad
    from repro_torch.optim.optimizers import adagrad

    tparams = tm.dlrm_init(tcfg, torch.Generator().manual_seed(0), "cpu")
    jparams = jax.tree.map(jnp.asarray, state_to_numpy(tparams))
    reports = {"grad": (jacc.grad_wire_bytes(jparams, JAUTO, 8),
                        accounting.grad_wire_bytes(tparams, AUTO, 8)),
               "dp": (jacc.dp_step_wire_bytes(jparams, "int8", 4, scalar_allreduces=3),
                      accounting.dp_step_wire_bytes(tparams, "int8", 4, scalar_allreduces=3))}
    # one step function: the two reference Trainers' jits share its compilation
    jstep = jloop.make_train_step(lambda p, b: jm.dlrm_loss_fn(p, b, jcfg), jadagrad(1e-2))
    for name, (jrep, trep) in reports.items():
        jo, to = jobs.Obs(), tobs.Obs()
        cfg = dict(num_steps=3, log_every=1)
        jloop.Trainer(jstep, jloop.TrainConfig(**cfg),
                      batch_at=lambda s: jbatch_at(0, s, 16, JCriteoSpec(table_sizes=(100, 5000,
                                                                                      33))),
                      obs=jo, step_wire=jrep).run(jloop.init_state(jparams, jadagrad(1e-2)))
        tloop.Trainer(tloop.make_train_step(lambda p, b: tm.dlrm_loss_fn(p, b, tcfg),
                                            adagrad(1e-2)),
                      tloop.TrainConfig(**cfg), batch_at=lambda s: batches(s, 16),
                      obs=to, step_wire=trep).run(tloop.init_state(tparams, adagrad(1e-2)))
        jser = jo.registry.snapshot()["train_wire_bytes_total"]["series"]
        tser = to.registry.snapshot()["train_wire_bytes_total"]["series"]
        assert tser == jser, name
        if name == "dp":
            assert [s["labels"] for s in tser] == [{"leaf": "_other", "mode": "aggregate"}]
        else:
            assert len(tser) == len(tree.leaves(tparams))


def test_convert_carries_the_dp_state_err():
    _, tm, _, tcfg, _ = _small()
    from repro.optim.optimizers import adagrad as jadagrad
    jparams = jax.tree.map(jnp.asarray, state_to_numpy(
        tm.dlrm_init(tcfg, torch.Generator().manual_seed(0), "cpu")))
    jstate = jloop.init_dp_state(jparams, jadagrad(1e-2), compress="auto")
    tstate = state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    assert set(tstate) == {"params", "opt", "step", "err"}
    back = state_to_numpy(tstate)
    for a, b in zip(jax.tree.leaves(jstate), tree.leaves(back)):
        np.testing.assert_array_equal(b, np.asarray(a))
    with pytest.raises(ValueError, match="train state holds"):
        state_from_jax({"params": {}, "err": {}}, device="cpu")


def _launch(args, tmp_path, torchrun=False):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable]
    if torchrun:
        cmd += ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2"]
    cmd += ["-m", "repro_torch.launch.train", "--device", "cpu"] + args
    return subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=300)


def test_launcher_on_the_cpu(tmp_path):
    from repro_torch.launch import train
    metrics = tmp_path / "m.jsonl"
    hist = train.main(["--device", "cpu", "--compress-policy", "auto", "--steps", "4",
                       "--batch", "16", "--log-every", "1", "--metrics-out", str(metrics),
                       "--trace", str(tmp_path / "t.json"),
                       "--ckpt-dir", str(tmp_path / "ck")])
    assert len(hist) == 4 and all(np.isfinite(x) for _, x in hist)
    assert not torch.distributed.is_initialized()
    lines = [json.loads(x) for x in metrics.read_text().splitlines()]
    wire = [x for x in lines if x["name"] == "train_wire_bytes_total"]
    assert len(wire) == 34 and all(x["value"] == 0.0 for x in wire)   # n = 1: 0 bytes
    assert (tmp_path / "ck").is_dir() and (tmp_path / "t.json").exists()
    again = train.main(["--device", "cpu", "--compress-policy", "auto", "--steps", "6",
                        "--batch", "16", "--log-every", "1", "--ckpt-dir", str(tmp_path / "ck")])
    assert [s for s, _ in again] == [4, 5]                # resumed from step 4
    plain = train.main(["--device", "cpu", "--steps", "2", "--batch", "16", "--arch",
                        "dcn-criteo", "--log-every", "1"])
    assert len(plain) == 2
    # the encoder-decoder trains through the launcher too, its frames from api.batch_fn
    seamless = train.main(["--device", "cpu", "--arch", "seamless-m4t-large-v2", "--steps", "1",
                           "--batch", "4", "--seq-len", "16", "--log-every", "1"])
    assert [s for s, _ in seamless] == [0] and np.isfinite(seamless[0][1])


def test_launcher_under_torchrun_with_two_gloo_ranks(tmp_path):
    proc = _launch(["--compress-policy", "int8", "--steps", "3", "--batch", "16",
                    "--log-every", "1", "--metrics-out", "m.jsonl"], tmp_path, torchrun=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "dp step over 2 device(s) (gloo), compress=int8" in proc.stdout
    assert proc.stdout.count("step     0  loss") == 1              # rank 0 prints
    like = dlrm_criteo.api(dlrm_criteo.config(reduced=True), device="cpu").init(
        torch.Generator().manual_seed(0))
    want = {e["path"]: 3 * e["wire_bytes"] for e in
            accounting.grad_wire_bytes(like, "int8", 2)["per_leaf"]}
    got = {x["labels"]["leaf"]: x["value"] for x in
           map(json.loads, (tmp_path / "m.jsonl").read_text().splitlines())
           if x["name"] == "train_wire_bytes_total"}
    assert got == want


def test_dist_bench_acceptance_on_a_gloo_world_of_8(tmp_path):
    """``dist_bench`` end to end (2 steps, the none and int8 lanes of both
    paths, as the reference's own acceptance test runs them): exits 0,
    recorded bytes equal the accounted bytes on every lane, int8 < 0.3×
    none on the dp path; the library entry runs on the card unless told
    otherwise, as the CLI does, and an unknown path exits 1."""
    import inspect

    from repro_torch.benchmarks import dist_bench
    out = tmp_path / "BENCH_dist.json"
    assert dist_bench.main(["--world", "8", "--backend", "gloo", "--device", "cpu",
                            "--steps", "2", "--policies", "none,int8", "--paths", "dp,fsdp",
                            "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["checks_failed"] == []
    assert report["int8_vs_none_ratio"] < dist_bench.INT8_RATIO_BAR
    assert [(r["path"], r["policy"]) for r in report["rows"]] == [
        ("dp", "none"), ("dp", "int8"), ("fsdp", "none"), ("fsdp", "int8")]
    for row in report["rows"]:
        assert row["recorded_wire_bytes"] == pytest.approx(row["wire_bytes"], rel=1e-12)
    assert report["rows"][2]["wire_bytes_param_gather"] > 0
    assert inspect.signature(dist_bench.bench).parameters["device"].default == "cuda"
    assert dist_bench.main(["--device", "cpu", "--paths", "dp,tp", "--out",
                            str(tmp_path / "x.json")]) == 1

"""The port's sharded serving — placement, the row exchange, the sharded
engine, the launcher and ``serve_dist_bench`` — held against the JAX
package on the CPU.

In one process: ``plan_placement`` equal to the reference's field for
field (uniform and mixed-width plans, quantized and f32 tables, 1 to 8
ranks, and the full-width int8 model over 4 ranks from shapes alone, on
the ``meta`` device), its specs, its byte accounting and
``memory_report(placement=)`` equal to the reference's, the placement
round-tripping through the plan JSON of either package, and the engine's
refusals.

In a gloo world of 8 (``dist.world.spawn``) beside one 8-device JAX
subprocess (``XLA_FLAGS`` set before ``import jax``), on the reduced
DLRM-Criteo at D=16 (path-based tables stay out: the reference's
path-based ``apply`` takes no ``gather=``, ROADMAP §3):

* ``exchange_rows`` bit-equal to the reference's exchange and to a local
  gather, f32 and int8, with the bytes ``dist.wire`` recorded equal to
  ``serve_exchange_wire_bytes``;
* the sharded engine against the port's single-device engine on the same
  stream (the reference's own sharded engine is not bit-equal to its
  single-device one under jax 0.9, ROADMAP §3, so the port holds its
  sharded engine to its own single-device engine): uniform, mixed-width
  and cache-on, plain and with the kernels' plain versions — bitwise,
  as every route runs the same arithmetic at the per-rank batch; the
  recorded exchange bytes per wave equal ``serve_wave_wire_bytes``; the
  cache's keys come from replicated features only and it hits; the obs
  wire counter; ``swap_plan`` refused;
* the launcher under ``torchrun`` with two ranks, and ``serve_dist_bench``.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import accounting as jacc
from repro.dist import serve_placement as jsp
from repro.dist.sharding import placement_specs as jplacement_specs
from repro.plan import MemoryPlan as JPlan
from repro.serve import quantize as jquant
from repro_torch import tree
from repro_torch.configs import dlrm_criteo
from repro_torch.dist import accounting, world
from repro_torch.dist import serve_placement as tsp
from repro_torch.plan import MemoryPlan, dim_ladder, plan_for_config
from repro_torch.serve import quantize as tquant
from repro_torch.serve.cache import DeviceHotRowCache, HotRowCache
from repro_torch.serve.recsys import RecsysEngine

ROOT = Path(__file__).resolve().parents[1]
N = 8
EX_ROWS, EX_WIDTH, EX_IDS = 64, 12, (64, 5)


def _cfg(plan=None):
    if plan is not None:
        return dlrm_criteo.config(reduced=True, plan=plan)
    return dataclasses.replace(dlrm_criteo.config(reduced=True), emb_dim=16)


@functools.lru_cache(maxsize=None)
def _plan():
    cfg = _cfg()
    return plan_for_config(cfg, 1 << 17, bytes_domain="serve_int8", num_batches=4,
                           batch_size=128, dims=dim_ladder(cfg.emb_dim))


@functools.lru_cache(maxsize=None)
def _model(name):
    """(port params, port qparams, reference params, reference qparams,
    plan) of the uniform or the mixed-width reduced model, drawn by the port
    on the CPU and carried to the reference as numpy."""
    plan = None if name == "uniform" else _plan()
    params = dlrm_criteo.api(_cfg(plan), device="cpu").init(torch.Generator().manual_seed(0))
    jparams = jax.tree.map(lambda x: jnp.asarray(x.numpy()), params)
    return (params, tquant.quantize_params(params, mode="int8"), jparams,
            jquant.quantize_params(jparams, mode="int8"), plan)


# ------------------------------------------------------------ placement


@pytest.mark.parametrize("name", ["uniform", "mixed"])
def test_plan_placement_equals_reference(name):
    params, qparams, jparams, jqparams, plan = _model(name)
    jplan = None if plan is None else JPlan.from_json(plan.to_json())
    for tp, jp in ((qparams, jqparams), (params, jparams)):
        for n in (1, 2, 4, 8):
            for p, jpl in ((None, None), (plan, jplan)):
                got = tsp.plan_placement(tp, n, plan=p)
                want = jsp.plan_placement(jp, n, plan=jpl)
                assert got.as_dict() == want.as_dict(), (name, n)
                assert got.summary() == want.summary()
                np.testing.assert_array_equal(got.replicated_features(10),
                                              want.replicated_features(10))
                for b, lb in ((2, 4), (32, 8)):
                    assert (accounting.serve_wave_wire_bytes(got, b, lb)
                            == jacc.serve_wave_wire_bytes(want, b, lb))
        assert tsp.plan_placement(tp, 8, threshold_bytes=100).as_dict() == \
            jsp.plan_placement(jp, 8, threshold_bytes=100).as_dict()
    pl = tsp.plan_placement(qparams, 8)
    assert pl.sharded and pl.bytes_per_device() <= (pl.total_bytes() // 8
                                                     + pl.replicated_bytes() + pl.pad_bytes())
    assert not tsp.plan_placement(qparams, 1).sharded


def test_full_width_placement_equals_reference():
    """The full-width int8 DLRM-Criteo over 4 ranks, from shapes alone: the
    placement, its bytes per rank and the wave's exchange bytes at 64
    requests per rank and bags of 4, each equal to the reference's."""
    cfg = dlrm_criteo.config(reduced=False)
    params = dlrm_criteo.api(cfg, device="meta").init(torch.Generator().manual_seed(0))

    def quant(t):                  # int8 rows, bf16 scale, int8 zero point
        return {"q": torch.empty(t.shape, dtype=torch.int8, device="meta"),
                "scale": torch.empty((t.shape[0], 1), dtype=torch.bfloat16, device="meta"),
                "zp": torch.empty((t.shape[0], 1), dtype=torch.int8, device="meta")}

    def jquant_(t):
        return {"q": jax.ShapeDtypeStruct(tuple(t.shape), jnp.int8),
                "scale": jax.ShapeDtypeStruct((t.shape[0], 1), jnp.bfloat16),
                "zp": jax.ShapeDtypeStruct((t.shape[0], 1), jnp.int8)}

    tq = {"tables": [{k: quant(v) for k, v in tp.items()} for tp in params["tables"]]}
    jq = {"tables": [{k: jquant_(v) for k, v in tp.items()} for tp in params["tables"]]}
    got, want = tsp.plan_placement(tq, 4), jsp.plan_placement(jq, 4)
    assert got.as_dict() == want.as_dict()
    wave = accounting.serve_wave_wire_bytes(got, 64, 4)
    assert wave == jacc.serve_wave_wire_bytes(want, 64, 4)
    sharded = [(e.feature, e.table_key, e.rows) for e in got.sharded]
    print(f"threshold {got.threshold_bytes} B; sharded {sharded}; replicated "
          f"{len(got.replicated)} ({got.replicated_bytes()} B); pad {got.pad_bytes()} B; "
          f"{got.bytes_per_device()} B per rank of {got.total_bytes()}; wave "
          f"{wave['total_bytes']} B, {wave['lookups_per_device']} lookups per rank")
    assert {key for _, key, _ in sharded} == {"table_0"}


@pytest.mark.parametrize("name", ["uniform", "mixed"])
def test_placement_specs_and_memory_report_equal_reference(name):
    params, qparams, jparams, jqparams, _ = _model(name)
    pl = tsp.plan_placement(qparams, 8)
    jpl = jsp.plan_placement(jqparams, 8)
    placed, specs = tsp.place_params(qparams, pl, 3)
    padded = jax.tree.map(lambda x: x, jqparams)
    for e in jpl.sharded:
        sub = padded["tables"][e.feature][e.table_key]
        for k in sub:
            sub[k] = jnp.concatenate([sub[k], jnp.zeros((e.padded_rows - sub[k].shape[0],)
                                                        + sub[k].shape[1:], sub[k].dtype)])
    jspecs = jplacement_specs(padded, jpl)
    def at(node, path):             # the spec at a leaf's path (specs are tuples)
        for k in path:
            node = node[k]
        return node

    got = [at(specs, path) for path, _ in tree.flatten_with_path(placed)]
    assert got == [tuple(s) for s in jax.tree.leaves(
        jspecs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))]
    for e in pl.sharded:
        block = placed["tables"][e.feature][e.table_key]
        assert all(v.shape[0] == pl.rows_per_device(e) for v in block.values())
        full = qparams["tables"][e.feature][e.table_key]["q"]
        r = pl.rows_per_device(e)
        assert torch.equal(block["q"][:max(0, min(r, full.shape[0] - 3 * r))],
                           full[3 * r:4 * r])
    assert tquant.memory_report(params, qparams, placement=pl) == \
        jquant.memory_report(jparams, jqparams, placement=jpl)
    with pytest.raises(ValueError, match="rank 8"):
        tsp.place_params(qparams, pl, 8)


def test_placement_round_trips_through_either_packages_plan_json(tmp_path):
    _, qparams, _, _, plan = _model("mixed")
    pl = tsp.plan_placement(qparams, 8, plan=plan)
    assert pl.threshold_bytes == max(1, plan.total_bytes // (4 * 8))
    plan.annotate_placement(pl)
    back = MemoryPlan.load(plan.save(str(tmp_path / "p.json"))).serve_placement()
    assert back.as_dict() == pl.as_dict()
    jback = JPlan.load(str(tmp_path / "p.json")).serve_placement()
    assert jback.as_dict() == pl.as_dict()
    jp = JPlan.from_json(plan.to_json())
    jp.annotate_placement(jback)
    assert MemoryPlan.from_json(jp.to_json()).serve_placement().as_dict() == pl.as_dict()
    assert tsp.ServePlacement.from_dict(pl.as_dict()).as_dict() == pl.as_dict()


def test_engine_sharded_mode_validation():
    _, qparams, _, _, _ = _model("uniform")
    cfg = _cfg()
    with pytest.raises(ValueError, match="multiple of"):
        RecsysEngine(cfg, qparams, max_batch=12, mesh_devices=8, device="cpu")
    with pytest.raises(NotImplementedError, match="DeviceHotRowCache"):
        RecsysEngine(cfg, qparams, max_batch=16, mesh_devices=8, cache=HotRowCache(),
                     device="cpu")
    with pytest.raises(TypeError, match="named DeviceMesh"):
        RecsysEngine(cfg, qparams, device="cpu", mesh=object())
    with pytest.raises(RuntimeError, match="none is initialized"):
        RecsysEngine(cfg, qparams, max_batch=16, mesh_devices=8, device="cpu")


# ------------------------------------------------------------ a world of 8


def _stream(cfg, count, max_bag=8):
    """The reference's parity stream: bag lengths pinned per 32-request
    block, every 4th request with one empty bag."""
    r = np.random.default_rng(1)
    reqs = []
    f = len(cfg.table_sizes)
    for k in range(count):
        length = max_bag if k % 32 == 0 else 1 + (k * 7) % max_bag
        dense = r.normal(size=(13,)).astype(np.float32)
        bags = [list(r.integers(0, s, size=length).astype(int)) for s in cfg.table_sizes]
        if k % 4 == 1:
            bags[k % f] = []
        reqs.append((dense, bags))
    return reqs


def _exchange_inputs(path):
    rng = np.random.default_rng(0)
    np.savez(path, table=rng.normal(size=(EX_ROWS, EX_WIDTH)).astype(np.float32),
             q=rng.integers(-128, 128, (EX_ROWS, EX_WIDTH)).astype(np.int8),
             scale=(rng.random((EX_ROWS, 1)) / 10).astype(np.float32),
             zp=rng.integers(-8, 8, (EX_ROWS, 1)).astype(np.int8),
             ids=rng.integers(0, EX_ROWS, EX_IDS).astype(np.int32))


def _scores(engine, reqs):
    uids = [engine.submit(d, b) for d, b in reqs]
    done = engine.run_until_drained()
    return np.asarray([done[u].score for u in uids], np.float32)


def _torch_world(rank, world_size, inputs, out_dir):
    """One rank: the exchange, then the engines; results to ``out_dir``."""
    from repro_torch.core.compositional import table_rows
    from repro_torch.dist import wire
    from repro_torch.obs import Obs
    from repro_torch.serve.recsys import _FEATURE_SHIFT

    torch.set_num_threads(1)
    d = np.load(inputs)
    res = {}
    per_rows, per_ids = EX_ROWS // world_size, EX_IDS[0] // world_size
    ids = torch.from_numpy(d["ids"][rank * per_ids:(rank + 1) * per_ids].copy())
    qt = {"q": torch.from_numpy(d["q"].copy()),
          "scale": torch.from_numpy(d["scale"].copy()).to(torch.bfloat16),
          "zp": torch.from_numpy(d["zp"].copy())}
    dense = torch.from_numpy(d["table"].copy())
    for name, full in (("f32", dense), ("int8", qt)):
        def mine(x):
            return x[rank * per_rows:(rank + 1) * per_rows]
        local = {k: mine(v) for k, v in full.items()} if name == "int8" else mine(full)
        wire.reset()
        got = tsp.exchange_rows(local, ids, world_size, per_rows, leaf_path="x")
        res[f"ex/{name}"] = got.numpy()
        res[f"ex_local/{name}"] = np.array(torch.equal(got, table_rows(full, ids)))
        res[f"ex_wire/{name}"] = np.array(wire.snapshot()["total_bytes"])

    reqs_cache = None
    for name, plan in (("uniform", None), ("mixed", _plan())):
        cfg = _cfg(plan)
        params = dlrm_criteo.api(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        qp = tquant.quantize_params(params, mode="int8")
        reqs = _stream(cfg, 128)
        for kernel in (False, True):
            kcfg = dataclasses.replace(cfg, use_kernel=kernel)
            one = RecsysEngine(kcfg, qp, max_batch=16 // world_size, batching="waves",
                               device="cpu")
            sharded = RecsysEngine(kcfg, qp, max_batch=16, batching="waves", device="cpu",
                                   mesh_devices=world_size)
            s1 = _scores(one, reqs)
            wire.reset()
            sn = _scores(sharded, reqs)
            snap = wire.snapshot()
            key = f"{name}/{int(kernel)}"
            res[f"one/{key}"], res[f"sharded/{key}"] = s1, sn
            res[f"exchange_bytes/{key}"] = np.array(sum(
                b for leaf, b in snap["per_leaf"].items() if leaf.startswith("tables/")))
            res[f"buckets/{key}"] = np.array(sharded.metrics()["buckets"])
            res[f"sharded_count/{name}"] = np.array(len(sharded.placement.sharded))
        if name == "uniform":
            reqs_cache = (cfg, qp, reqs)
            try:
                sharded.swap_plan(cfg, qp)
            except NotImplementedError as e:
                res["swap_refused"] = np.array(str(e))

    cfg, qp, reqs = reqs_cache
    cache = DeviceHotRowCache(capacity_rows=1 << 14, device="cpu")
    engine = RecsysEngine(cfg, qp, max_batch=16, batching="waves", device="cpu",
                          mesh_devices=world_size, cache=cache)
    res["cache/first"] = _scores(engine, reqs)
    res["cache/second"] = _scores(engine, reqs)
    res["cache/hit_rate"] = np.array(engine.metrics()["cache"]["hit_rate"])
    res["cache/paths"] = np.array(json.dumps(engine.metrics()["cache_paths"]))
    keys, _ = cache.slot_items()
    res["cache/features"] = np.unique(np.asarray(keys) >> _FEATURE_SHIFT)
    res["cache/replicated"] = engine.placement.replicated_features(len(cfg.table_sizes))

    obs = Obs()
    engine = RecsysEngine(cfg, qp, max_batch=16, batching="waves", device="cpu",
                          mesh_devices=world_size, obs=obs)
    _scores(engine, reqs[:32])
    res["obs/wire"] = np.array(obs.registry.snapshot()["serve_wire_bytes_total"]["series"][0]
                               ["value"])
    res["obs/waves"] = np.array(engine.metrics()["waves"])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


_JAX = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.dist.serve_placement import exchange_rows

    d = np.load(sys.argv[1])
    mesh = jax.make_mesh((8,), ("data",))
    rows = d["table"].shape[0]
    qt = {"q": jnp.asarray(d["q"]), "scale": jnp.asarray(d["scale"]).astype(jnp.bfloat16),
          "zp": jnp.asarray(d["zp"])}
    res = {}
    for name, leaf in (("f32", jnp.asarray(d["table"])), ("int8", qt)):
        fn = shard_map(lambda l, i: exchange_rows(l, i, 8, rows // 8, axis="data"),
                       mesh=mesh, in_specs=(P("data"), P("data")), out_specs=P("data"))
        res[f"ex/{name}"] = np.asarray(jax.jit(fn)(leaf, jnp.asarray(d["ids"])))
    np.savez(sys.argv[2], **res)
""")


@pytest.fixture(scope="module")
def runs():
    with tempfile.TemporaryDirectory(prefix="test_torch_serve_dist_") as d:
        inputs = os.path.join(d, "inputs.npz")
        _exchange_inputs(inputs)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
        ref = subprocess.Popen([sys.executable, "-c", _JAX, inputs, os.path.join(d, "jax.npz")],
                               env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True)
        try:
            world.spawn(_torch_world, N, "gloo", inputs, d)
        finally:
            _, err = ref.communicate(timeout=600)
        assert ref.returncode == 0, err[-3000:]
        jres = dict(np.load(os.path.join(d, "jax.npz")))
        ranks = [dict(np.load(os.path.join(d, f"rank{r}.npz"))) for r in range(N)]
        yield jres, ranks


@pytest.mark.parametrize("name", ["f32", "int8"])
def test_exchange_rows_bit_equal_to_reference_and_local_gather(runs, name):
    jres, ranks = runs
    per = EX_IDS[0] // N
    width = EX_WIDTH
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res[f"ex/{name}"], jres[f"ex/{name}"][r * per:(r + 1) * per])
        assert bool(res[f"ex_local/{name}"])
        want = accounting.serve_exchange_wire_bytes(per * EX_IDS[1], width, N,
                                                    quantized=name == "int8")["total_bytes"]
        assert float(res[f"ex_wire/{name}"]) == want


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel_route"])
@pytest.mark.parametrize("name", ["uniform", "mixed"])
def test_sharded_engine_equals_the_single_device_engine(runs, name, kernel):
    """Bitwise on every rank: each rank serves the per-rank batch through the
    same arithmetic as the single-device engine at that batch (the
    exchanged rows are bit-identical to a local gather; with the kernel
    route the replicated features take the grouped launch's plain version
    and the sharded ones ``bag_pool``, which pool alike on the CPU)."""
    _, ranks = runs
    key = f"{name}/{int(kernel)}"
    for res in ranks:
        np.testing.assert_array_equal(res[f"sharded/{key}"], res[f"one/{key}"])
        assert np.isfinite(res[f"sharded/{key}"]).all()
    cfg = _cfg(None if name == "uniform" else _plan())
    params = dlrm_criteo.api(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    pl = tsp.plan_placement(tquant.quantize_params(params, mode="int8"), N)
    assert int(ranks[0][f"sharded_count/{name}"]) == len(pl.sharded) > 0
    (bb, lb), = [tuple(b) for b in ranks[0][f"buckets/{key}"]]   # every wave one bucket
    want = accounting.serve_wave_wire_bytes(pl, bb // N, lb)["total_bytes"]
    assert float(ranks[0][f"exchange_bytes/{key}"]) == 128 // 16 * want


def test_sharded_cache_hits_replicated_features_only(runs):
    _, ranks = runs
    for res in ranks:
        np.testing.assert_array_equal(res["cache/first"], ranks[0]["one/uniform/0"])
        np.testing.assert_array_equal(res["cache/second"], ranks[0]["one/uniform/0"])
        assert float(res["cache/hit_rate"]) > 0
        feats = set(res["cache/features"].tolist())
        assert feats and feats <= set(np.flatnonzero(res["cache/replicated"]).tolist())
        paths = json.loads(str(res["cache/paths"]))
        assert paths["fast"] > 0
        np.testing.assert_array_equal(res["cache/features"], ranks[0]["cache/features"])


def test_sharded_engine_refuses_swap_plan_and_counts_its_wire(runs):
    _, ranks = runs
    assert all("single-host only" in str(res["swap_refused"]) for res in ranks)
    cfg = _cfg()
    params = dlrm_criteo.api(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    pl = tsp.plan_placement(tquant.quantize_params(params, mode="int8"), N)
    per_wave = accounting.serve_wave_wire_bytes(pl, 16 // N, 8)["total_bytes"]
    assert float(ranks[0]["obs/wire"]) == int(ranks[0]["obs/waves"]) * int(per_wave)


# ------------------------------------------------------------ entry points


def test_launcher_under_torchrun_with_two_ranks(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", "repro_torch.launch.serve", "--device", "cpu", "--mesh-devices", "2",
           "--requests", "24", "--batch-size", "7"]
    proc = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert "--batch-size 7 -> 8" in out
    assert "placement: " in out and "sub-tables over 2 devices" in out
    assert out.count("served 24 requests") == 1                 # rank 0 prints
    with pytest.raises(SystemExit, match="torchrun"):
        from repro_torch.launch import serve
        serve.main(["--device", "cpu", "--mesh-devices", "2"])


def test_serve_dist_bench_on_a_gloo_world_of_4(tmp_path):
    from repro_torch.benchmarks import serve_dist_bench
    out = tmp_path / "BENCH_serve_dist.json"
    assert serve_dist_bench.main(["--device", "cpu", "--world", "4", "--requests", "128",
                                  "--reps", "1", "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["checks_failed"] == []
    assert report["wire"]["recorded_wire_bytes"] == report["wire"]["wire_bytes"] > 0
    assert report["parity"]["bitwise"] and report["parity"]["bitwise_cache"]
    assert report["qps"]["gated"] is False

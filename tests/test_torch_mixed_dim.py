"""Mixed-width planned embeddings in the port, held against the JAX package.

The reference's mixed-dimension plan (``tests/test_mixed_dim.py``: four
power-law features at 0.25 x the full tables over widths {4, 8, 16}) is
solved by both planners — equal plans — and drives both packages: the
factory builds each table at its planned width and refuses a width above
``emb_dim``; the uniform tree keeps no ``"proj"`` key and its draws; the
projections' keys and shapes match; DLRM and DCN forward and
``value_and_grad`` on the reference's parameters (carried across by
``params_from_jax``) agree, projections included; ``memory_report``
counts the plan's int8 bytes; ``serve_bench``'s mixed-dimension lane runs
with its checks.  Then the reference's golden 512-request mixed-plan
trace (``tests/test_serve_path.py``) through the port's engine with a
``DeviceHotRowCache``: waves, buckets, cache stats and the event log's
SHA-1 equal the reference's pinned goldens (imported from that file), the
device cache equals cache off bit for bit, and the scores agree with the
JAX engine's.

Tolerances: logits 1e-4 (f32 summation order through the pooling, the
projections, the interaction and two MLPs, ``test_torch_dlrm.py``); loss
and gradients f32 1e-5, gradients relative to each leaf's largest
magnitude (``test_torch_dcn.py``).
"""

import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_serve_path import (GOLDEN_BUCKETS, GOLDEN_CACHE, GOLDEN_EVENTS_SHA1, GOLDEN_WAVES,
                             TRACE_N, _trace)

from repro import plan as jplan
from repro.core import make_embedding as jmake
from repro.models import dcn as jdcn
from repro.models import dlrm as jdlrm
from repro.serve.cache import DeviceHotRowCache as JDeviceCache
from repro.serve.quantize import memory_report as jmemory_report
from repro.serve.quantize import quantize_params as jquantize
from repro.serve.recsys import RecsysEngine as JaxEngine
from repro_torch import plan as tplan
from repro_torch import tree
from repro_torch.benchmarks import serve_bench
from repro_torch.configs import dlrm_criteo
from repro_torch.convert import params_from_jax, state_to_numpy
from repro_torch.core import EmbeddingSpec as TSpec
from repro_torch.core import make_embedding as tmake
from repro_torch.data.criteo import CriteoSpec, batch_at
from repro_torch.kernels import grouped_lookup
from repro_torch.models import dcn as tdcn
from repro_torch.models import dlrm as tdlrm
from repro_torch.optim.optimizers import adagrad
from repro_torch.serve.cache import DeviceHotRowCache
from repro_torch.serve.quantize import memory_report, quantize_params, table_shapes
from repro_torch.serve.recsys import RecsysEngine
from repro_torch.train import loop as tloop

SIZES = (100, 500, 33, 2000)
DIM = 16
SCORE_TOL = 1e-4


def _plans(frac=0.25, arch="test-mixed"):
    """The reference's mixed plan, solved by both packages: (JAX, port)."""
    budget = int(jplan.full_table_bytes(SIZES, DIM) * frac)
    jp = jplan.build_plan([jplan.power_law_stats(n, alpha=1.2) for n in SIZES], DIM, budget,
                          dims=jplan.dim_ladder(DIM), arch=arch)
    tp = tplan.build_plan([tplan.power_law_stats(n, alpha=1.2) for n in SIZES], DIM, budget,
                          dims=tplan.dim_ladder(DIM), arch=arch)
    assert tplan.plan_differences(tp, tplan.MemoryPlan.from_json(jp.to_json()), 0.0) == []
    assert len(set(tp.table_dims)) >= 2, tp.table_dims
    return jp, tp


def _dlrm_cfgs(use_kernel=False, **kw):
    jp, tp = _plans(**kw)
    base = dict(table_sizes=SIZES, emb_dim=DIM, bottom_mlp=(32, 16), top_mlp=(32,))
    return (jdlrm.DLRMConfig(embedding=jp, **base),
            tdlrm.DLRMConfig(embedding=tp, use_kernel=use_kernel, **base))


def _np_tree(p):
    return jax.tree.map(np.asarray, p)


def _batch(b=6, length=3, seed=0):
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(b, 13)).astype(np.float32)
    one_hot = np.stack([rng.integers(0, s, size=b) for s in SIZES], axis=1).astype(np.int32)
    multi = np.stack([rng.integers(0, s, size=(b, length)) for s in SIZES],
                     axis=1).astype(np.int32)
    mask = (rng.random((b, len(SIZES), length)) > 0.3).astype(np.float32)
    mask[0] = 0.0                                        # every bag empty
    mask[:, 0::2, :] *= (rng.random((b, 1, 1)) > 0.5)    # some features' bags empty
    label = (rng.random(b) > 0.5).astype(np.float32)
    return dense, one_hot, multi, mask, label


def _assert_leaves_close(jtree, ttree, tol):
    jl = [np.asarray(x, np.float32) for x in jax.tree.leaves(jtree)]
    tl = tree.leaves(state_to_numpy(ttree))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=tol * max(1.0, float(np.abs(a).max())))


# ------------------------------------------------------------------ factory


def test_make_embedding_builds_at_planned_width():
    jp, tp = _plans()
    for i, n in enumerate(SIZES):
        tmod, jmod = tmake(n, DIM, tp, feature=i), jmake(n, DIM, jp, feature=i)
        assert type(tmod).__name__ == type(jmod).__name__
        assert tmod.out_dim == jmod.out_dim == tp.dim_for(i)
        assert tmod.num_params == jmod.num_params
        assert tmod.num_params * 4 == tp.tables[i].train_bytes


def test_make_embedding_refuses_what_the_reference_refuses():
    _, tp = _plans()
    with pytest.raises(ValueError, match="feature="):
        tmake(SIZES[0], DIM, tp)
    with pytest.raises(ValueError, match="regenerate"):
        tmake(SIZES[0] + 1, DIM, tp, feature=0)          # other cardinality
    with pytest.raises(ValueError, match="regenerate"):
        tmake(SIZES[0], DIM * 2, tp, feature=0)          # other emb_dim
    with pytest.raises(ValueError, match="no feature"):
        tmake(SIZES[0], DIM, tp, feature=len(SIZES))
    tp.tables[0] = dataclasses.replace(tp.tables[0], dim=DIM + 4)
    with pytest.raises(ValueError, match="width"):
        tmake(SIZES[0], DIM, tp, feature=0)


def test_uniform_config_keeps_its_tree_and_draws():
    """A uniform-width config draws the tree it drew before projections
    existed: no ``"proj"`` key, bottom, top, then the tables from one
    generator, leaf for leaf."""
    cfg = tdlrm.DLRMConfig(table_sizes=SIZES, emb_dim=DIM, bottom_mlp=(32, 16), top_mlp=(32,),
                           embedding=TSpec(kind="qr", num_collisions=4, threshold=40))
    params = tdlrm.dlrm_init(cfg, torch.Generator().manual_seed(7), "cpu")
    assert set(params) == {"bottom", "top", "tables"}
    gen = torch.Generator().manual_seed(7)
    modules = tdlrm.tables_for(cfg)
    f = len(SIZES) + 1
    want = {"bottom": tdlrm._mlp_init(gen, (13, 32, 16, DIM), torch.float32, "cpu"),
            "top": tdlrm._mlp_init(gen, (f * (f - 1) // 2 + DIM, 32, 1), torch.float32, "cpu"),
            "tables": [m.init(gen, "cpu") for m in modules]}
    for a, b in zip(tree.leaves(params), tree.leaves(want)):
        assert torch.equal(a, b)
    # a uniform-width plan brings no projection either
    st = [tplan.power_law_stats(n, alpha=1.2) for n in SIZES]
    uniform = tplan.build_plan(st, DIM, tplan.full_table_bytes(SIZES, DIM))
    assert set(uniform.table_dims) == {DIM}
    ucfg = dataclasses.replace(cfg, embedding=uniform)
    assert "proj" not in tdlrm.dlrm_init(ucfg, torch.Generator().manual_seed(0), "cpu")


def test_proj_init_keys_shapes_and_scale_match_the_reference():
    jcfg, tcfg = _dlrm_cfgs()
    jparams = jdlrm.dlrm_init(jax.random.PRNGKey(0), jcfg)
    tparams = tdlrm.dlrm_init(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert sorted(tparams["proj"]) == sorted(jparams["proj"])
    for k, w in tparams["proj"].items():
        assert tuple(w.shape) == jparams["proj"][k].shape == (tcfg.embedding.dim_for(int(k)), DIM)
        assert w.dtype == torch.float32
    # the generator's last draws: randn((d, D)) * (1/d) ** 0.5 in feature order
    modules = tdlrm.tables_for(tcfg)
    gen = torch.Generator().manual_seed(0)
    f = len(SIZES) + 1
    tdlrm._mlp_init(gen, (13, 32, 16, DIM), torch.float32, "cpu")
    tdlrm._mlp_init(gen, (f * (f - 1) // 2 + DIM, 32, 1), torch.float32, "cpu")
    for m in modules:
        m.init(gen, "cpu")
    again = tdlrm.proj_init(gen, modules, tcfg, "cpu")
    assert sorted(again) == sorted(tparams["proj"])
    for k, w in again.items():
        assert torch.equal(w, tparams["proj"][k])
    # num_params counts the projections, as the reference's does
    total = sum(x.numel() for x in tree.leaves(tparams))
    assert total == tdlrm.dlrm_num_params(tcfg) == jdlrm.dlrm_num_params(jcfg)
    dcfg = tdcn.DCNConfig(table_sizes=SIZES, emb_dim=DIM, cross_layers=2, deep_mlp=(32, 16),
                          embedding=tcfg.embedding)
    dparams = tdcn.dcn_init(dcfg, torch.Generator().manual_seed(0), "cpu")
    assert sorted(dparams["proj"]) == sorted(tparams["proj"])


@pytest.mark.parametrize("d_out", [16, 32, 64, 128])
def test_every_ladder_width_fits_k4s_shared_memory(d_out):
    """K4 stages a table's projection and its block's pooled bags in shared
    memory: every width of the ladder up to D=128, at any threads per bag
    the launcher picks, fits under the H100's per-block limit."""
    for d in tplan.dim_ladder(d_out):
        for elem in (1, 2, 4):                      # int8, bf16, f32 rows
            tpb = grouped_lookup._threads_per_bag(d * elem)
            assert grouped_lookup.proj_smem_bytes(d, d_out, tpb) <= grouped_lookup._SMEM_MAX
        for tpb in (1, 2, 4, 8, 16, 32):
            assert grouped_lookup.proj_smem_bytes(d, d_out, tpb) <= grouped_lookup._SMEM_MAX


# ------------------------------------------------------------------ models


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mixed_dlrm_forward_matches_the_reference(use_kernel):
    jcfg, tcfg = _dlrm_cfgs(use_kernel=use_kernel)
    jparams = jdlrm.dlrm_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(_np_tree(jparams), device="cpu")
    dense, one_hot, multi, mask, _ = _batch()
    for quant in (None, "int8"):
        jp = jquantize(jparams) if quant else jparams
        tp = params_from_jax(_np_tree(jp), device="cpu") if quant else tparams
        want = jdlrm.dlrm_forward(jp, jnp.asarray(dense), jnp.asarray(one_hot), jcfg)
        got = tdlrm.dlrm_forward(tp, torch.from_numpy(dense), torch.from_numpy(one_hot), tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SCORE_TOL,
                                   atol=SCORE_TOL)
        want = jdlrm.dlrm_forward(jp, jnp.asarray(dense), jnp.asarray(multi), jcfg,
                                  mask=jnp.asarray(mask))
        got = tdlrm.dlrm_forward(tp, torch.from_numpy(dense), torch.from_numpy(multi), tcfg,
                                 mask=torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SCORE_TOL,
                                   atol=SCORE_TOL)


def test_mixed_dlrm_loss_and_gradients_match_the_reference():
    """One ``value_and_grad`` on the reference's parameters: loss, accuracy
    and every gradient leaf — the narrow tables and their projections —
    as ``jax.value_and_grad``'s."""
    jcfg, tcfg = _dlrm_cfgs()
    jparams = jdlrm.dlrm_init(jax.random.PRNGKey(1), jcfg)
    tparams = params_from_jax(_np_tree(jparams), device="cpu")
    dense, one_hot, _, _, label = _batch(b=32, seed=2)
    batch = {"dense": dense, "sparse": one_hot, "label": label}
    (jloss, jm), jg = jax.value_and_grad(lambda p, x: jdlrm.dlrm_loss_fn(p, x, jcfg),
                                         has_aux=True)(jparams, {k: jnp.asarray(v)
                                                                 for k, v in batch.items()})
    (tloss, tm), tg = tloop.value_and_grad(lambda p, x: tdlrm.dlrm_loss_fn(p, x, tcfg))(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert float(tm["acc"]) == float(jm["acc"])
    assert sorted(tg["proj"]) == sorted(jg["proj"])
    assert any(float(g.abs().max()) > 0 for g in tg["proj"].values())
    _assert_leaves_close(jg, tg, 1e-5)


def test_mixed_dcn_forward_and_gradients_match_the_reference():
    jp_plan, tp_plan = _plans()
    base = dict(table_sizes=SIZES, emb_dim=DIM, cross_layers=2, deep_mlp=(32, 16))
    jcfg = jdcn.DCNConfig(embedding=jp_plan, **base)
    tcfg = tdcn.DCNConfig(embedding=tp_plan, **base)
    jparams = jdcn.dcn_init(jax.random.PRNGKey(1), jcfg)
    assert "proj" in jparams
    tparams = params_from_jax(_np_tree(jparams), device="cpu")
    dense, one_hot, multi, mask, label = _batch(b=16, seed=3)
    want = jdcn.dcn_forward(jparams, jnp.asarray(dense), jnp.asarray(multi), jcfg,
                            mask=jnp.asarray(mask))
    got = tdcn.dcn_forward(tparams, torch.from_numpy(dense), torch.from_numpy(multi), tcfg,
                           mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SCORE_TOL, atol=SCORE_TOL)
    batch = {"dense": dense, "sparse": one_hot, "label": label}
    (jloss, _), jg = jax.value_and_grad(lambda p, x: jdcn.dcn_loss_fn(p, x, jcfg),
                                        has_aux=True)(jparams, {k: jnp.asarray(v)
                                                                for k, v in batch.items()})
    (tloss, _), tg = tloop.value_and_grad(lambda p, x: tdcn.dcn_loss_fn(p, x, tcfg))(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    _assert_leaves_close(jg, tg, 1e-5)


def test_mixed_dlrm_trains_through_the_projections():
    """A few Adagrad steps from a mixed plan through the port's train step:
    finite losses, and the projections move."""
    _, tcfg = _dlrm_cfgs()
    opt = adagrad(1e-2)
    state = tloop.init_state(tdlrm.dlrm_init(tcfg, torch.Generator().manual_seed(0), "cpu"), opt)
    step = tloop.make_train_step(lambda p, b: tdlrm.dlrm_loss_fn(p, b, tcfg), opt)
    spec = CriteoSpec(table_sizes=SIZES, zipf=1.5, noise=0.5)
    k = sorted(state["params"]["proj"])[0]
    p0 = state["params"]["proj"][k].clone()
    for i in range(3):
        state, m = step(state, batch_at(0, i, 32, spec, device="cpu"))
        assert np.isfinite(float(m["loss"]))
    assert not torch.equal(p0, state["params"]["proj"][k])


# ------------------------------------------------------------------ serving


def test_memory_report_counts_the_plans_int8_bytes():
    jcfg, tcfg = _dlrm_cfgs()
    jparams = jdlrm.dlrm_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(_np_tree(jparams), device="cpu")
    qp = quantize_params(tparams)
    rep = memory_report(tparams, qp)
    want = jmemory_report(jparams, jquantize(jparams))
    assert rep["table_dims"] == want["table_dims"] == sorted(set(tcfg.embedding.table_dims))
    assert rep["quant_table_bytes"] == want["quant_table_bytes"] \
        == sum(t.serve_bytes_int8 for t in tcfg.embedding.tables)
    assert rep["f32_table_bytes"] == sum(t.train_bytes for t in tcfg.embedding.tables)
    assert all(w.dtype == torch.float32 for w in qp["proj"].values())   # not table leaves
    assert {w for _, _, w in table_shapes(qp)} == set(tcfg.embedding.table_dims)


def test_serve_bench_mixed_lane_runs_with_its_checks_on_the_cpu():
    """``serve_bench``'s mixed-dimension lane on the reduced DLRM at D=64:
    the plan's widths are per feature, built bytes equal the plan in both
    domains, the cache path's scores equal the in-graph path's, hits > 0;
    and its checks flag what the reference's flag."""
    from benchmarks import serve_bench as jbench

    cfg = dataclasses.replace(dlrm_criteo.config(reduced=True), emb_dim=serve_bench.SERVE_EMB_DIM)
    reqs = serve_bench._requests(cfg, CriteoSpec(table_sizes=cfg.table_sizes, zipf=1.5,
                                                 noise=0.5), 24, "cpu")
    row = serve_bench._mixed_dim_cell("dlrm-criteo", cfg, reqs, 8, torch.device("cpu"))
    assert len(row["plan_dims"]) >= 2 and row["plan_built_bytes_ok"]
    assert row["table_bytes"] == row["planned_serve_bytes"]
    assert row["cache_vs_ingraph_max_dscore"] <= 1e-3 and row["hit_rate"] > 0
    assert serve_bench.check({"rows": [], "mixed_rows": [row]}) == []
    bad = dict(row, plan_built_bytes_ok=False, plan_dims=[64], table_bytes=1,
               cache_vs_ingraph_max_dscore=1.0, hit_rate=0.0, plan_bytes=row["budget_bytes"] + 1)
    report = {"rows": [], "mixed_rows": [bad]}
    assert serve_bench.check(report) == jbench.check(report)
    assert len(serve_bench.check(report)) == 6


# ------------------------------------------------ the golden mixed-plan trace


@pytest.fixture(scope="module")
def golden_runs():
    """The reference's 512-request trace (``tests/test_serve_path.py``) on
    its mixed plan, int8 tables from the reference's ``dlrm_init``: the
    port's engine cache off, with the device cache (exact path, events
    recorded), and the JAX engine cache off."""
    jp, tp = _plans(arch="serve-path-golden")
    base = dict(table_sizes=SIZES, emb_dim=DIM, bottom_mlp=(32, 16), top_mlp=(32,))
    jcfg = jdlrm.DLRMConfig(embedding=jp, **base)
    tcfg = tdlrm.DLRMConfig(embedding=tp, use_kernel=True, **base)
    jq = jquantize(jdlrm.dlrm_init(jax.random.PRNGKey(0), jcfg))
    tq = params_from_jax(_np_tree(jq), device="cpu")
    reqs = _trace()
    assert len(reqs) == TRACE_N

    def run(eng):
        uids = [eng.submit(d, b) for d, b in reqs]
        done = eng.run_until_drained()
        return np.array([done[u].score for u in uids], np.float32), eng

    cache = DeviceHotRowCache(capacity_rows=4096, record_events=True, device="cpu")
    return {"off": run(RecsysEngine(tcfg, tq, max_batch=32, device="cpu")),
            "device": run(RecsysEngine(tcfg, tq, max_batch=32, cache=cache, device="cpu")),
            "jax": run(JaxEngine(jcfg, jq, max_batch=32)),
            "jax_device": run(JaxEngine(jcfg, jq, max_batch=32,
                                        cache=JDeviceCache(4096, record_events=True))),
            "cache": cache}


def test_golden_trace_waves_buckets_cache_and_events(golden_runs):
    """The port's engine with the device cache reproduces the reference's
    pinned goldens: waves, buckets, cache stats and the event log's SHA-1,
    through the per-feature slab branch (projections, widths 4, 8, 16)."""
    _, eng = golden_runs["device"]
    m = eng.metrics()
    assert not eng._uniform and sorted(golden_runs["cache"]._slabs) == sorted(set(eng._widths))
    assert m["waves"] == GOLDEN_WAVES
    assert m["buckets"] == GOLDEN_BUCKETS
    assert golden_runs["off"][1].metrics()["waves"] == GOLDEN_WAVES
    assert m["cache"] == GOLDEN_CACHE
    sha = hashlib.sha1(repr(golden_runs["cache"].events).encode()).hexdigest()
    assert sha == GOLDEN_EVENTS_SHA1
    assert m["cache_paths"]["exact"] == GOLDEN_WAVES


def test_golden_trace_scores_device_cache_equals_off_and_the_jax_engine(golden_runs):
    off, dev = golden_runs["off"][0], golden_runs["device"][0]
    assert np.isfinite(off).all()
    np.testing.assert_array_equal(dev, off)
    np.testing.assert_allclose(off, golden_runs["jax"][0], rtol=0, atol=SCORE_TOL)
    np.testing.assert_allclose(dev, golden_runs["jax_device"][0], rtol=0, atol=SCORE_TOL)

"""The port's ``obs`` (registry, tracer, collision telemetry) and the
engine's and trainer's observability, held against the JAX package.

The registry and the telemetry are stdlib and numpy in both packages, so
equal operations give equal snapshots, JSONL text, stats and masses
exactly.  The tracer's Chrome trace equals the reference's for the same
caller-timed events.  On one request trace (parameters drawn by JAX and
carried across) the port's engine records the same served ids as the JAX
engine; its stage partition tiles each wave's latency (ratio 1 within
1e-9, both batching modes, every cache kind), and observability changes
no score by a single bit.
"""

import json

import jax
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import EmbeddingSpec as JSpec
from repro.data.criteo import CriteoSpec as JCriteoSpec
from repro.data.criteo import batch_at as jbatch_at
from repro.models.dlrm import DLRMConfig as JCfg
from repro.models.dlrm import dlrm_init as jax_dlrm_init
from repro.models.dlrm import dlrm_loss_fn as jax_loss_fn
from repro.models.dlrm import tables_for as jtables_for
from repro.optim.optimizers import adagrad as jadagrad
from repro.plan.freq import FeatureStats as JStats
from repro.serve import cache as jcache
from repro.serve.quantize import quantize_params as jax_quantize_params
from repro.serve.recsys import RecsysEngine as JaxEngine
from repro.train import loop as jloop
from repro_torch import obs as tobs
from repro_torch.convert import params_from_jax
from repro_torch.core import EmbeddingSpec as TSpec
from repro_torch.data.criteo import CriteoSpec, batch_at
from repro_torch.models.dlrm import DLRMConfig as TCfg
from repro_torch.models.dlrm import dlrm_loss_fn, tables_for
from repro_torch.optim.optimizers import adagrad
from repro_torch.plan.freq import FeatureStats
from repro_torch.serve.cache import DeviceHotRowCache, HotRowCache
from repro_torch.serve.recsys import STAGE_PARTITION, STAGES, RecsysEngine
from repro_torch.train import loop as tloop

SIZES = (100, 500, 33)
BASE = dict(table_sizes=SIZES, emb_dim=16, bottom_mlp=(32, 16), top_mlp=(32,))
CACHES = ("off", "device", "fast", "host")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small tensors: test files run
    side by side in worker processes, and idle spinning threads of several
    of them at once slow every process on the host."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


def _cfgs(kind="qr", **kw):
    spec = dict(kind=kind, num_collisions=4, threshold=40)
    return (JCfg(embedding=JSpec(**spec), **BASE),
            TCfg(embedding=TSpec(**spec), use_kernel=True, **BASE, **kw))


def _params(jcfg):
    jp = jax_quantize_params(jax_dlrm_init(jax.random.PRNGKey(0), jcfg))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _requests(n, seed=0, sizes=SIZES, max_bag=3):
    """The reference obs tests' request generator."""
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=13),
             [list(rng.integers(0, s, size=rng.integers(1, max_bag + 1))) for s in sizes])
            for _ in range(n)]


def _cache(kind):
    return {"off": None, "device": DeviceHotRowCache(512, record_events=True, device="cpu"),
            "fast": DeviceHotRowCache(512, device="cpu"), "host": HotRowCache(512)}[kind]


def _jcache(kind):
    return {"off": None, "device": jcache.DeviceHotRowCache(512, record_events=True),
            "fast": jcache.DeviceHotRowCache(512), "host": jcache.HotRowCache(512)}[kind]


def _serve(eng, reqs):
    uids = [eng.submit(d, b) for d, b in reqs]
    done = eng.run_until_drained()
    return np.array([done[u].score for u in uids], np.float64)


# ------------------------------------------------------------------ registry


def _registry_ops(seed, n=200):
    """A seeded sequence of registry operations: (kind, name, value, labels)."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        kind = ("counter", "gauge", "histogram")[int(rng.integers(3))]
        name = f"{kind}_{int(rng.integers(2))}"
        labels = {"stage": ("a", "b", "c")[int(rng.integers(3))]} if rng.random() < 0.7 else {}
        ops.append((kind, name, float(rng.lognormal()), labels))
    return ops


def _apply(reg, ops):
    for kind, name, value, labels in ops:
        getattr(reg, kind)(name, "h").labels(**labels)
        if kind == "counter":
            reg.counter(name).inc(value, **labels)
        elif kind == "gauge":
            reg.gauge(name).set(value, **labels)
        else:
            reg.histogram(name, max_samples=50).observe(value, **labels)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_same_operations_same_snapshot_and_jsonl(seed, tmp_path):
    ops = _registry_ops(seed)
    t, j = _apply(tobs.MetricsRegistry(), ops), _apply(jobs.MetricsRegistry(), ops)
    assert t.snapshot() == j.snapshot()
    assert t.to_jsonl() == j.to_jsonl()
    # files interchange both ways: each package's file holds the other's lines
    pt, pj = t.save_jsonl(str(tmp_path / "t.jsonl")), j.save_jsonl(str(tmp_path / "j.jsonl"))
    with open(pt) as a, open(pj) as b:
        assert [json.loads(x) for x in a] == [json.loads(x) for x in b]


@pytest.mark.parametrize("q", [0, 10, 50, 90, 99, 100])
def test_histogram_percentiles_equal_numpy(q):
    samples = np.random.default_rng(0).lognormal(size=257)
    h = tobs.MetricsRegistry().histogram("lat")
    for s in samples:
        h.observe(float(s))
    assert h.percentile(q) == pytest.approx(float(np.percentile(samples, q)), rel=1e-12)
    jh = jobs.MetricsRegistry().histogram("lat")
    for s in samples:
        jh.observe(float(s))
    assert h.percentile(q) == jh.percentile(q)


def test_registry_errors_and_bounds():
    reg = tobs.MetricsRegistry()
    c = reg.counter("requests")
    assert reg.counter("requests") is c
    with pytest.raises(TypeError):
        reg.gauge("requests")
    with pytest.raises(ValueError):
        c.inc(-1)
    with pytest.raises(ValueError):
        reg.histogram("empty").percentile(50)
    h = reg.histogram("b", max_samples=4)
    for v in range(10):
        h.observe(float(v))
    assert h.labels().samples == [6.0, 7.0, 8.0, 9.0]
    assert (h.labels().count, h.labels().sum) == (10, 45.0)


def test_registry_merge_and_reset_equal_reference():
    def build(mod):
        a, b = mod.MetricsRegistry(), mod.MetricsRegistry()
        a.counter("serve_c").inc(1, k="x")
        b.counter("serve_c").inc(2, k="x")
        b.counter("serve_c").inc(7, k="y")
        a.gauge("g").set(1)
        b.gauge("g").set(9)
        a.histogram("serve_h").observe(1.0)
        b.histogram("serve_h").observe(3.0)
        a.merge(b)
        merged = a.snapshot()
        handle = a.counter("serve_c").labels(k="x")
        other = a.gauge("g").labels()
        a.reset(prefix="serve_")
        handle.inc(4)                       # a bound handle stays live
        return merged, a.snapshot(), other.value

    t, j = build(tobs), build(jobs)
    assert t == j
    merged, after, other = t
    series = {tuple(s["labels"].items()): s["value"] for s in merged["serve_c"]["series"]}
    assert series == {(("k", "x"),): 3.0, (("k", "y"),): 7.0}
    assert merged["g"]["series"][0]["value"] == 9.0 and other == 9.0
    assert merged["serve_h"]["series"][0]["count"] == 2
    assert {tuple(s["labels"].items()): s["value"] for s in after["serve_c"]["series"]} \
        == {(("k", "x"),): 4.0, (("k", "y"),): 0.0}


# ------------------------------------------------------------------- tracer


def test_tracer_chrome_trace_equals_reference():
    tt, jt = tobs.Tracer(), jobs.Tracer()
    tt._t0 = jt._t0 = 1000.0
    rng = np.random.default_rng(0)
    for k in range(20):
        t0, dur = 1000.0 + float(rng.random()), float(rng.random()) * 1e-3
        args = {"requests": k, "batch": 4} if k % 3 else {}
        for tr in (tt, jt):
            tr.complete(("wave", "probe", "dense")[k % 3], t0, dur, **args)
    # the port's payload adds the origin on the profiler's clock, as metadata
    payload = tt.chrome_trace()
    assert set(payload.pop("otherData")) == {"origin_unix_ns"}
    assert payload == jt.chrome_trace()
    assert {k: v for k, v in json.loads(tt.to_json()).items() if k != "otherData"} \
        == json.loads(jt.to_json())
    assert tt.drain() == jt.drain() and len(tt) == 0


def test_tracer_spans_nest_and_bound():
    tr = tobs.Tracer(max_events=3)
    with tr.span("outer", kind="t"):
        with tr.span("inner"):
            pass
    tr.complete("mark", 0.0, 0.0)
    evs = json.loads(tr.to_json())["traceEvents"]
    assert [e["name"] for e in evs] == ["inner", "outer", "mark"]
    assert [e.get("args", {}).get("depth") for e in evs] == [1, 0, None]
    tr.complete("late", 0.0, 0.0)
    assert [e["name"] for e in tr.drain()] == ["outer", "mark", "late"]


def test_tracer_profiler_annotations_mirror_spans():
    from torch.profiler import ProfilerActivity, profile

    tr = tobs.Tracer(profiler_annotations=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with tr.span("outer"):
                torch.ones(4).sum()
        tr.range_end(tr.range_begin("wave"))
    names = [e.name for e in prof.events()]
    assert names.count("outer") == 3 and names.count("wave") == 1
    assert tobs.Tracer().range_begin("wave") is None


# ------------------------------------------------------- collision telemetry


def _wave_stream(seed, waves=9, b=6, lb=3):
    rng = np.random.default_rng(seed)
    for _ in range(waves):
        idx = np.stack([rng.integers(0, s, size=(b, lb)) for s in SIZES], axis=1)
        mask = (rng.random((b, len(SIZES), lb)) < 0.7).astype(np.float32)
        yield idx.astype(np.int32), mask, int(rng.integers(1, b + 1))


@pytest.mark.parametrize("kind", ["qr", "hash"])
def test_collision_telemetry_equals_reference(kind):
    jcfg, tcfg = _cfgs(kind)
    tmods, jmods = tables_for(tcfg), jtables_for(jcfg)
    rng = np.random.default_rng(5)
    base = [rng.integers(0, s, size=s // 3) for s in SIZES]
    tt, jt = tobs.CollisionTelemetry(SIZES, compact_every=2), \
        jobs.CollisionTelemetry(SIZES, compact_every=2)
    tt.set_baseline(base)
    jt.set_baseline(base)
    for idx, mask, live in _wave_stream(1):
        tt.record(idx, mask, live_rows=live)
        jt.record(idx, mask, live_rows=live)
    assert (tt.waves, tt.requests) == (jt.waves, jt.requests)
    predicted = [FeatureStats(size=s, ids=np.arange(s // 2), probs=np.full(s // 2, 2 / s))
                 for s in SIZES]
    jpredicted = [JStats(size=p.size, ids=p.ids, probs=p.probs) for p in predicted]
    for i in range(len(SIZES)):
        a, b = tt.observed_stats(i), jt.observed_stats(i)
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.probs, b.probs)
        assert tt.observed_lookups(i) == jt.observed_lookups(i) > 0
        assert tt.unseen_id_rate(i) == jt.unseen_id_rate(i)
        assert tt.measured_collision_mass(tmods[i], i) == jt.measured_collision_mass(jmods[i], i)
    assert tt.report(tmods, predicted_stats=predicted) == \
        jt.report(jmods, predicted_stats=jpredicted)
    assert any(r["measured_collision_mass"] > 0 for r in tt.report(tmods))
    tt.reset()
    assert tt.waves == 0 and all(tt.observed_lookups(i) == 0 for i in range(len(SIZES)))
    assert tt.unseen_id_rate(0) == 0.0      # the baseline survives a window reset


# -------------------------------------------------------------- engine obs


@pytest.fixture(scope="module")
def engines():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("batching", ["continuous", "waves"])
@pytest.mark.parametrize("cache", CACHES)
def test_engine_records_the_ids_the_jax_engine_records(engines, batching, cache):
    jcfg, tcfg, jp, tp = engines
    reqs = _requests(23, seed=3)
    jo, to = jobs.Obs(collisions=True), tobs.Obs(collisions=True)
    jeng = JaxEngine(jcfg, jp, max_batch=4, cache=_jcache(cache), batching=batching, obs=jo)
    teng = RecsysEngine(tcfg, tp, max_batch=4, cache=_cache(cache), batching=batching,
                        obs=to, device="cpu")
    np.testing.assert_allclose(_serve(teng, reqs), _serve(jeng, reqs), rtol=0, atol=1e-4)
    jt, tt = jo.collisions, to.collisions
    assert (tt.waves, tt.requests) == (jt.waves, jt.requests) == (teng.metrics()["waves"], 23)
    for i in range(len(SIZES)):
        assert tt.observed_lookups(i) == jt.observed_lookups(i) > 0
        a, b = tt.observed_stats(i), jt.observed_stats(i)
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.probs, b.probs)
    jc, tc = jo.registry.counter("serve_requests_total"), to.registry.counter(
        "serve_requests_total")
    assert tc.value() == jc.value() == len(reqs)
    assert to.registry.counter("serve_waves_total").value() \
        == jo.registry.counter("serve_waves_total").value()


@pytest.mark.parametrize("batching", ["continuous", "waves"])
@pytest.mark.parametrize("cache", CACHES)
def test_engine_stage_partition_tiles_the_wave_latency(engines, batching, cache):
    _, tcfg, _, tp = engines
    obs = tobs.Obs(trace=True, collisions=True)
    eng = RecsysEngine(tcfg, tp, max_batch=4, cache=_cache(cache), batching=batching, obs=obs,
                       device="cpu")
    reqs = _requests(13, seed=3)
    assert len(_serve(eng, reqs)) == len(reqs)
    ss = eng.stage_summary()
    assert set(STAGES) <= set(ss)
    assert ss["partition"]["ratio"] == pytest.approx(1.0, abs=1e-9)
    assert ss["partition"]["latency_sum_s"] > 0
    waves = eng.metrics()["waves"]
    assert all(ss[s]["count"] == waves for s in STAGES)
    names = [e["name"] for e in obs.tracer.events]
    assert names.count("wave") == waves
    assert all(names.count(s) == waves for s in STAGE_PARTITION)
    assert obs.collisions.waves == waves


@pytest.mark.parametrize("cache", CACHES)
def test_engine_obs_is_read_only_bitwise(engines, cache):
    _, tcfg, _, tp = engines
    reqs = _requests(17, seed=5) * 2
    off = RecsysEngine(tcfg, tp, max_batch=4, cache=_cache(cache), device="cpu")
    on = RecsysEngine(tcfg, tp, max_batch=4, cache=_cache(cache), device="cpu",
                      obs=tobs.Obs(trace=True, collisions=True, profiler_annotations=True))
    np.testing.assert_array_equal(_serve(on, reqs), _serve(off, reqs))
    assert on.metrics()["waves"] == off.metrics()["waves"]
    if cache != "off":
        assert on.metrics()["cache"] == off.metrics()["cache"]


def test_engine_obs_zero_requests_and_all_empty_bags(engines):
    _, tcfg, _, tp = engines
    obs = tobs.Obs(trace=True, collisions=True)
    eng = RecsysEngine(tcfg, tp, max_batch=4, obs=obs, device="cpu")
    ss = eng.stage_summary()
    assert ss["partition"]["ratio"] == 1.0 and ss["probe"]["count"] == 0
    assert eng.run_until_drained() == {}
    rng = np.random.default_rng(0)
    uids = [eng.submit(rng.normal(size=13), [[], [], []]) for _ in range(3)]
    done = eng.run_until_drained()
    assert all(np.isfinite(done[u].score) for u in uids)
    ss = eng.stage_summary()
    assert ss["probe"]["count"] > 0
    assert ss["partition"]["ratio"] == pytest.approx(1.0, abs=1e-9)
    assert obs.collisions.observed_lookups(0) == 0
    with pytest.raises(RuntimeError, match="Obs"):
        RecsysEngine(tcfg, tp, max_batch=4, device="cpu").stage_summary()


@pytest.mark.parametrize("cache", ["device", "host"])
def test_reset_metrics_keeps_the_cache_residency(engines, cache):
    _, tcfg, _, tp = engines
    obs = tobs.Obs()
    eng = RecsysEngine(tcfg, tp, max_batch=4, cache=_cache(cache), obs=obs, device="cpu")
    reqs = _requests(16, seed=7)
    _serve(eng, reqs)
    st = eng.cache.stats
    assert st.lookups > 0 and st.misses > 0 and st.bytes_cached > 0
    resident = st.bytes_cached
    eng.metrics()
    assert obs.registry.gauge("serve_cache_stat").value(stat="bytes_cached") == resident
    eng.reset_metrics()
    st = eng.cache.stats
    assert (st.hits, st.misses, st.lookups) == (0, 0, 0) and st.bytes_cached == resident
    assert eng.wave_latencies_s == []
    assert obs.registry.counter("serve_requests_total").value() == 0
    _serve(eng, reqs)
    m = eng.metrics()
    assert m["cache"]["hit_rate"] == 1.0 and m["cache"]["misses"] == 0
    assert obs.registry.counter("serve_requests_total").value() == len(reqs)


def test_swap_warmup_never_feeds_the_telemetry(engines):
    _, tcfg, _, tp = engines
    obs = tobs.Obs(collisions=True)
    eng = RecsysEngine(tcfg, tp, max_batch=4, cache=_cache("fast"), obs=obs, device="cpu")
    _serve(eng, _requests(9, seed=2))
    waves, lookups = obs.collisions.waves, obs.collisions.observed_lookups(0)
    info = eng.swap_plan(tcfg, tp)
    assert info["buckets_warmed"]
    assert (obs.collisions.waves, obs.collisions.observed_lookups(0)) == (waves, lookups)


# -------------------------------------------------------------- trainer obs


def test_trainer_obs_counters_equal_reference():
    jcfg, tcfg = _cfgs()
    tcfg = TCfg(embedding=tcfg.embedding, **BASE)
    jparams = jax_dlrm_init(jax.random.PRNGKey(0), jcfg)
    jstate = jloop.init_state(jparams, jadagrad(1e-2))
    tstate = tloop.init_state(params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"),
                              adagrad(1e-2))
    cfg = dict(num_steps=6, log_every=2)
    jo, to = jobs.Obs(trace=True), tobs.Obs(trace=True)
    jtr = jloop.Trainer(jloop.make_train_step(lambda p, b: jax_loss_fn(p, b, jcfg),
                                              jadagrad(1e-2)),
                        jloop.TrainConfig(**cfg),
                        batch_at=lambda s: jbatch_at(0, s, 16, JCriteoSpec(table_sizes=SIZES)),
                        obs=jo)
    ttr = tloop.Trainer(tloop.make_train_step(lambda p, b: dlrm_loss_fn(p, b, tcfg),
                                              adagrad(1e-2)),
                        tloop.TrainConfig(**cfg),
                        batch_at=lambda s: batch_at(0, s, 16, CriteoSpec(table_sizes=SIZES),
                                                    "cpu"),
                        obs=to)
    _, jhist = jtr.run(jstate)
    _, thist = ttr.run(tstate)
    assert [s for s, _ in thist] == [s for s, _ in jhist]
    for reg, tr in ((to.registry, ttr), (jo.registry, jtr)):
        assert reg.counter("train_steps_total").value() == 6
        h = reg.histogram("train_step_seconds").labels()
        assert h.count == 6 and h.sum > 0
        assert reg.counter("train_straggler_events_total").value() == len(tr.straggler_events)
    assert sorted(to.registry.snapshot()) == sorted(jo.registry.snapshot())
    # the port's tracer also holds the program's own repro.* spans
    steps = [(e["name"], e["args"]) for e in to.tracer.events
             if not e["name"].startswith("repro.")]
    assert steps == [(e["name"], e["args"]) for e in jo.tracer.events]
    assert steps == [("train_step", {"step": k}) for k in range(6)]


def test_trainer_obs_keeps_the_loss_bits():
    _, tcfg = _cfgs()
    tcfg = TCfg(embedding=tcfg.embedding, **BASE)
    from repro_torch.models.dlrm import dlrm_init

    def run(obs):
        state = tloop.init_state(dlrm_init(tcfg, torch.Generator().manual_seed(0), "cpu"),
                                 adagrad(1e-2))
        tr = tloop.Trainer(tloop.make_train_step(lambda p, b: dlrm_loss_fn(p, b, tcfg),
                                                 adagrad(1e-2)),
                           tloop.TrainConfig(num_steps=5, log_every=1),
                           batch_at=lambda s: batch_at(0, s, 16, CriteoSpec(table_sizes=SIZES),
                                                       "cpu"), obs=obs)
        return tr.run(state)[1]

    assert run(tobs.Obs(trace=True)) == run(None)


# ------------------------------------------------------ serve_bench obs lane


def test_serve_bench_obs_lane_runs_with_its_checks_on_the_cpu(tmp_path, monkeypatch):
    """``serve_bench``'s obs lane on the reduced DLRM at D=64 (mixed-width
    plan, int8, device cache, continuous and waves): the partition ratio is
    1, obs-on scores equal obs-off, the collision table has predicted and
    measured mass; and on fixed reports its checks flag what the
    reference's flag (the QPS ratio is a timing check, held here on fixed
    reports only: a loaded CPU can stall one pass)."""
    import dataclasses

    from benchmarks import serve_bench as jbench
    from repro_torch.benchmarks import serve_bench
    from repro_torch.configs import dlrm_criteo

    monkeypatch.chdir(tmp_path)
    cfg = dataclasses.replace(dlrm_criteo.config(reduced=True), emb_dim=serve_bench.SERVE_EMB_DIM)
    spec = CriteoSpec(table_sizes=cfg.table_sizes, zipf=1.5, noise=0.5)
    reqs = serve_bench._requests(cfg, spec, 24, "cpu")
    rows, table, art = serve_bench._obs_lane("dlrm-criteo", cfg, spec, reqs, 8,
                                             torch.device("cpu"))
    assert [r["batching"] for r in rows] == ["continuous", "waves"]
    for r in rows:
        assert r["scores_identical"] and r["stage_sum_ratio"] == pytest.approx(1.0, abs=1e-9)
        assert len(r["qps_ratios"]) == serve_bench.OBS_REPS and r["trace_events"] > 0
    assert art is not None and len(art.tracer) > 0
    report = {"rows": [], "obs_rows": rows, "collision_tables": {"dlrm-criteo": table}}
    assert [m for _, m in serve_bench.check(report) if "qps ratio" not in m] == []
    bad = {"rows": [], "obs_rows": [dict(rows[0], qps_ratio=0.5, stage_sum_ratio=1.5,
                                         scores_identical=False)],
           "collision_tables": {"dlrm-criteo": [dict(t, measured_collision_mass=0.0)
                                                for t in table]}}
    assert serve_bench.check(bad) == jbench.check(bad) and len(serve_bench.check(bad)) == 4
    summary = serve_bench.summarize_obs(dict(report, checks_failed=[]))
    assert summary["acceptance"]["stage_sum_within_tol"]
    assert summary["acceptance"]["collision_predicted_vs_observed"]
    assert set(summary) >= set(jbench.summarize_obs(dict(report, checks_failed=[])))

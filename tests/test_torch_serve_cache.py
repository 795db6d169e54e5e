"""The port's engine with the hot-row cache, held against the reference.

The reference's 512-request trace (``tests/test_serve_path.py:280``: Zipf
ids, empty bags, all-empty requests) runs through the JAX package's
``RecsysEngine`` and the port's (CPU) on one uniform-width int8 QR config
(``SIZES``, D=16, c=4), with parameters drawn by JAX and carried across by
``params_from_jax``.  On the port's side the device cache's scores equal
cache off bit for bit, with the kernel route on and off (on the CPU both
take the plain versions, and the slab pool uses ``bag_pool``'s expression);
the host cache pools in numpy, within 1e-6.  Against the JAX engine the
scores agree within 1e-4 (f32 summation order through pooling,
interaction and two MLPs, the reference's own engine bound), and waves,
buckets, cache stats, the event log, ``swap_plan``'s result and
``compile_count`` are equal.
"""

import hashlib

import jax
import numpy as np
import pytest
import torch

from repro.core import EmbeddingSpec as JSpec
from repro.models.dcn import DCNConfig as JDCNCfg
from repro.models.dcn import dcn_init as jax_dcn_init
from repro.models.dlrm import DLRMConfig as JCfg
from repro.models.dlrm import dlrm_init as jax_dlrm_init
from repro.serve import cache as jcache
from repro.serve.quantize import quantize_params as jax_quantize_params
from repro.serve.recsys import RecsysEngine as JaxEngine
from repro_torch.convert import params_from_jax
from repro_torch.core import EmbeddingSpec as TSpec
from repro_torch.models.dcn import DCNConfig as TDCNCfg
from repro_torch.models.dlrm import DLRMConfig as TCfg
from repro_torch.serve.cache import DeviceHotRowCache, HotRowCache
from repro_torch.serve.recsys import RecsysEngine

SIZES = (100, 500, 33, 2000)
BASE = dict(table_sizes=SIZES, emb_dim=16, bottom_mlp=(32, 16), top_mlp=(32,))
SCORE_TOL = 1e-4


def _trace(n=512, seed=11):
    """The reference's trace generator (``tests/test_serve_path.py:280``)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for r in range(n):
        if r % 16 == 15:
            bags = [[] for _ in SIZES]             # all-empty request
        else:
            bags = [list((rng.zipf(1.3, size=int(rng.integers(0, 6))) - 1) % s)
                    for s in SIZES]
        reqs.append((rng.normal(size=13), bags))
    return reqs


def _cfgs(c=4, use_kernel=True, sizes=SIZES):
    base = dict(BASE, table_sizes=sizes)
    spec = dict(kind="qr", num_collisions=c)
    return (JCfg(embedding=JSpec(**spec), **base),
            TCfg(embedding=TSpec(**spec), use_kernel=use_kernel, **base))


def _params(jcfg, init=jax_dlrm_init):
    jp = jax_quantize_params(init(jax.random.PRNGKey(0), jcfg))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _run(eng, reqs):
    uids = [eng.submit(d, b) for d, b in reqs]
    done = eng.run_until_drained()
    return np.array([done[u].score for u in uids], np.float32)


def _caches(kind):
    """(reference cache, port cache) of one kind: none, the device cache on
    the exact path (``record_events`` keeps the probe off), the device
    cache with the probe, or the host cache; 4,096 rows."""
    return {"off": (None, None),
            "device": (jcache.DeviceHotRowCache(4096, record_events=True),
                       DeviceHotRowCache(4096, record_events=True, device="cpu")),
            "fast": (jcache.DeviceHotRowCache(4096), DeviceHotRowCache(4096, device="cpu")),
            "host": (jcache.HotRowCache(4096), HotRowCache(4096))}[kind]


def _sha(events):
    return hashlib.sha1(repr(events).encode()).hexdigest()


@pytest.fixture(scope="module")
def trace_runs():
    """The trace through the JAX engine and the port's, each cache kind."""
    jcfg, tcfg = _cfgs()
    _, plain = _cfgs(use_kernel=False)
    jp, tp = _params(jcfg)
    reqs = _trace()
    out = {}
    for kind in ("off", "device", "fast", "host"):
        jeng = JaxEngine(jcfg, jp, max_batch=32, cache=_caches(kind)[0])
        out["jax", kind] = (_run(jeng, reqs), jeng)
        for route, cfg in (("kernel", tcfg), ("plain", plain)):
            teng = RecsysEngine(cfg, tp, max_batch=32, cache=_caches(kind)[1], device="cpu")
            out[route, kind] = (_run(teng, reqs), teng)
    return out


def test_trace_device_cache_equals_cache_off_bit_for_bit(trace_runs):
    want = trace_runs["plain", "off"][0]
    assert np.isfinite(want).all()
    for key in (("kernel", "off"), ("plain", "device"), ("kernel", "device"),
                ("plain", "fast"), ("kernel", "fast")):
        np.testing.assert_array_equal(trace_runs[key][0], want, err_msg=str(key))
    for route in ("plain", "kernel"):
        np.testing.assert_allclose(trace_runs[route, "host"][0], want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cache", ["off", "device", "fast", "host"])
def test_trace_scores_match_the_jax_engine(trace_runs, cache):
    want = trace_runs["jax", cache][0]
    for route in ("plain", "kernel"):
        np.testing.assert_allclose(trace_runs[route, cache][0], want, rtol=0, atol=SCORE_TOL)


@pytest.mark.parametrize("cache", ["off", "device", "fast", "host"])
def test_trace_waves_buckets_and_cache_stats_match_the_jax_engine(trace_runs, cache):
    jm = trace_runs["jax", cache][1].metrics()
    for route in ("plain", "kernel"):
        tm = trace_runs[route, cache][1].metrics()
        assert (tm["waves"], tm["requests"], tm["buckets"]) == \
            (jm["waves"], jm["requests"], jm["buckets"])
        assert tm.get("cache") == jm.get("cache")


def test_trace_event_log_matches_the_jax_engine(trace_runs):
    want = _sha(trace_runs["jax", "device"][1].cache.events)
    for route in ("plain", "kernel"):
        eng = trace_runs[route, "device"][1]
        assert _sha(eng.cache.events) == want
        assert eng.metrics()["cache_paths"]["exact"] == eng.metrics()["waves"]


@pytest.mark.parametrize("cache", ["off", "device", "fast", "host"])
def test_compile_count_matches_the_jax_engine(trace_runs, cache):
    want = trace_runs["jax", cache][1].compile_count()
    assert None not in want["per_program"].values()
    for route in ("plain", "kernel"):
        assert trace_runs[route, cache][1].compile_count() == want


def test_fast_path_takes_waves_and_equals_the_exact_path(trace_runs):
    """The speculative slot-map probe serves waves (reduced id space), and
    its scores equal the exact path's; a probe that saw a miss settles
    through the exact path at reap."""
    for route in ("plain", "kernel"):
        fast = trace_runs[route, "fast"]
        paths = fast[1].metrics()["cache_paths"]
        assert paths["fast"] > 0 and paths["probe_missed"] > 0
        assert paths["fast"] + paths["exact"] + paths["ingraph"] == fast[1].metrics()["waves"]
        np.testing.assert_array_equal(fast[0], trace_runs[route, "device"][0])


@pytest.mark.parametrize("use_kernel", [True, False])
def test_tiny_cache_serves_in_graph_bit_identical(use_kernel):
    """A cache smaller than one wave's working set rejects admission and
    serves the wave through the cache-off embed: bit-identical to cache
    off, with the reference's rejections."""
    sizes = SIZES[:3]
    base = dict(BASE, table_sizes=sizes)
    spec = dict(kind="qr", num_collisions=4, threshold=40)
    jcfg = JCfg(embedding=JSpec(**spec), **base)
    tcfg = TCfg(embedding=TSpec(**spec), use_kernel=use_kernel, **base)
    jp, tp = _params(jcfg)
    reqs = [(d, b[:3]) for d, b in _trace(48, seed=5)]
    off = _run(RecsysEngine(tcfg, tp, max_batch=8, device="cpu"), reqs)
    tiny = DeviceHotRowCache(capacity_rows=2, device="cpu")
    eng = RecsysEngine(tcfg, tp, max_batch=8, cache=tiny, device="cpu")
    np.testing.assert_array_equal(_run(eng, reqs), off)
    assert tiny.stats.rejections > 0 and eng.metrics()["cache_paths"]["ingraph"] > 0
    jtiny = jcache.DeviceHotRowCache(capacity_rows=2)
    _run(JaxEngine(jcfg, jp, max_batch=8, cache=jtiny), reqs)
    assert tiny.stats.as_dict() == jtiny.stats.as_dict()


def test_reset_metrics_keeps_resident_bytes():
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    cache = DeviceHotRowCache(4096, device="cpu")
    eng = RecsysEngine(tcfg, tp, max_batch=32, cache=cache, device="cpu")
    _run(eng, _trace(64))
    resident = cache.stats.bytes_cached
    assert resident > 0 and eng.metrics()["cache"]["lookups"] > 0
    eng.reset_metrics()
    m = eng.metrics()
    assert m["cache"]["bytes_cached"] == resident and m["cache"]["lookups"] == 0
    assert set(m["cache_paths"].values()) == {0} and m["waves"] == 0


@pytest.mark.parametrize("record_events", [True, False])
def test_swap_plan_matches_the_jax_engine(record_events):
    """Drain, invalidate, install, warm: the result dict, the cache stats and
    ``compile_count`` equal the reference's, and the scores after the swap
    equal a fresh engine's on the new config (and the JAX engine's)."""
    jcfg4, tcfg4 = _cfgs(c=4)
    jcfg2, tcfg2 = _cfgs(c=2)
    jp4, tp4 = _params(jcfg4)
    jp2, tp2 = _params(jcfg2)
    reqs = _trace(160)
    first, second = reqs[:96], reqs[96:]
    jc = jcache.DeviceHotRowCache(4096, record_events=record_events)
    tc = DeviceHotRowCache(4096, record_events=record_events, device="cpu")
    jeng = JaxEngine(jcfg4, jp4, max_batch=32, cache=jc)
    teng = RecsysEngine(tcfg4, tp4, max_batch=32, cache=tc, device="cpu")
    for eng in (jeng, teng):
        for d, b in first:
            eng.submit(d, b)
        for _ in range(3):                # leave waves in flight and queued
            eng.step()
    resident, version = len(tc), tc.residency_version
    assert resident == len(jc) > 0 and teng._inflight
    left = [(r.dense, r.bags) for r in teng._queue]      # served after the swap
    want = jeng.swap_plan(jcfg2, jp2)
    got = teng.swap_plan(tcfg2, tp2)
    assert got == want
    # the drain admits the in-flight waves' rows on the old plan, then all go
    assert got["invalidated_rows"] >= resident and got["residency_version"] != version
    assert tc.stats.as_dict() == jc.stats.as_dict()
    assert teng.compile_count() == jeng.compile_count()
    jafter, tafter = _run(jeng, second), _run(teng, second)
    fresh = RecsysEngine(tcfg2, tp2, max_batch=32, device="cpu")
    np.testing.assert_array_equal(tafter, _run(fresh, left + second)[len(left):])
    np.testing.assert_allclose(tafter, jafter, rtol=0, atol=SCORE_TOL)
    assert teng.compile_count() == jeng.compile_count()
    assert teng.metrics()["waves"] == jeng.metrics()["waves"]
    with pytest.raises(ValueError, match="table_sizes"):
        teng.swap_plan(_cfgs(sizes=SIZES[:3])[1], tp2)


@pytest.mark.parametrize("cache", ["off", "device", "fast", "host"])
def test_dcn_engine_matches_the_jax_dcn_engine(cache):
    """DCN serving: the dense stage is ``dcn_forward_from_features``; the
    cache-on scores equal the port's cache off bit for bit (host: 1e-6)
    and the JAX DCN engine's within 1e-4."""
    base = dict(table_sizes=SIZES, emb_dim=16, cross_layers=2, deep_mlp=(32, 16))
    spec = dict(kind="qr", num_collisions=4)
    jcfg = JDCNCfg(embedding=JSpec(**spec), **base)
    tcfg = TDCNCfg(embedding=TSpec(**spec), **base)
    jp, tp = _params(jcfg, init=jax_dcn_init)
    reqs = _trace(96, seed=3)
    jc, tc = _caches(cache)
    jeng = JaxEngine(jcfg, jp, max_batch=32, cache=jc)
    teng = RecsysEngine(tcfg, tp, max_batch=32, cache=tc, device="cpu")
    want, got = _run(jeng, reqs), _run(teng, reqs)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_TOL)
    off = _run(RecsysEngine(tcfg, tp, max_batch=32, device="cpu"), reqs)
    if cache == "host":
        np.testing.assert_allclose(got, off, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, off)
    assert teng.metrics().get("cache") == jeng.metrics().get("cache")
    assert teng.compile_count() == jeng.compile_count()


def test_slab_forward_per_feature_branch_equals_the_uniform_gather():
    """The slab pool's per-feature branch (mixed widths, mixed row dtypes or
    projections, which a memory plan brings) gives the one-gather branch's
    bits on a uniform config."""
    jcfg, tcfg = _cfgs(use_kernel=False)
    _, tp = _params(jcfg)
    reqs = _trace(96)
    want = _run(RecsysEngine(tcfg, tp, max_batch=32, device="cpu"), reqs)
    eng = RecsysEngine(tcfg, tp, max_batch=32, device="cpu",
                       cache=DeviceHotRowCache(4096, device="cpu"))
    assert eng._uniform
    eng._uniform = False
    np.testing.assert_array_equal(_run(eng, reqs), want)


def test_engine_refuses_a_cache_on_another_device():
    _, tcfg = _cfgs()
    params = {"tables": [], "bottom": [], "top": []}
    with pytest.raises(ValueError, match="device"):
        RecsysEngine(tcfg, params, device="cpu", cache=DeviceHotRowCache(8, device="meta"))
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="device"):
            RecsysEngine(tcfg, params, device="cpu", cache=DeviceHotRowCache(8))


def test_serve_bench_runs_its_checks_on_the_cpu(tmp_path, capsys, monkeypatch):
    """The bench's grid (2 archs x 3 modes x cache off / on, and int8 in
    waves batching), its obs lane and its acceptance checks at a few steps
    and requests.  The p99 bound and the obs lane's QPS ratio are timing
    checks, held here on fixed reports: a loaded CPU can stall one wave
    past them."""
    import json

    from repro_torch.benchmarks import serve_bench

    monkeypatch.chdir(tmp_path)
    report = serve_bench.bench(2, 24, 32, device="cpu")
    assert len(report["rows"]) == 16
    assert {(r["arch"], r["mode"], r["cache"], r["batching"]) for r in report["rows"]} == {
        (a, m, c, b) for a in serve_bench.ARCHS for m in serve_bench.MODES for c in ("off", "on")
        for b in (("continuous", "waves") if m == "int8" else ("continuous",))}
    assert [m for _, m in serve_bench.check(report)
            if not m.startswith(("p99", "obs-on best paired qps ratio"))] == []
    assert [(r["arch"], r["batching"]) for r in report["obs_rows"]] == [
        (a, b) for a in serve_bench.ARCHS for b in ("continuous", "waves")]
    assert set(report["collision_tables"]) == set(serve_bench.ARCHS)
    for r in report["rows"]:
        assert (r["hit_rate"] > 0) if r["cache"] == "on" else r["hit_rate"] is None
        if r["mode"] == "int8":
            assert r["bytes_ratio"] <= serve_bench.INT8_BYTES_BAR and r["row_bound_ok"]
    row = dict(report["rows"][5], p50_ms=1.0, p99_ms=5.0)
    bad = dict(row, hit_rate=0.0, loss=row["loss"] + 1, p99_ms=21.0)
    assert {m.split()[0] for _, m in serve_bench.check({"rows": [bad]})} == {"p99", "loss",
                                                                             "cache"}
    out = tmp_path / "bench.json"
    obs_rows = [dict(r, qps_ratio=1.0) for r in report["obs_rows"]]
    monkeypatch.setattr(serve_bench, "bench",
                        lambda *a: dict(report, rows=[row], obs_rows=obs_rows))
    assert serve_bench.main(["--device", "cpu", "--out", str(out)]) == 0
    assert json.loads(out.read_text())["checks_failed"] == []
    summary = json.loads((tmp_path / "artifacts" / "bench_torch" / "BENCH_obs.json").read_text())
    assert summary["acceptance"]["all_checks_passed"] and len(summary["lanes"]) == 4
    assert not list(tmp_path.glob("BENCH_*.json"))
    printed = capsys.readouterr().out
    assert "serve/dlrm-criteo/int8/cache_on/continuous" in printed
    assert "serve/dlrm-criteo/obs/waves" in printed


def test_serve_soak_runs_and_gates_on_its_baseline(tmp_path, monkeypatch):
    """The soak's protocol for a second, then its checks and baseline on
    fixed reports: a one-second run has too few pumps for the residency
    check, whose halves compare admissions over a long stream."""
    import json

    from repro_torch.benchmarks import serve_soak

    report = serve_soak.soak(1.0, device="cpu")
    assert report["served"] > 0 and report["hit_rate"] > 0.5 and report["timeseries"]
    assert 0 < report["bytes_cached"] <= serve_soak.CACHE_ROWS * 64 * 4
    ok = dict(report, bytes_ok=True)
    base = tmp_path / "baseline.json"
    args = ["--device", "cpu", "--duration", "1", "--baseline", str(base),
            "--out", str(tmp_path / "soak.json"), "--timeseries-out", str(tmp_path / "ts.csv")]
    monkeypatch.setattr(serve_soak, "soak", lambda *a: ok)
    assert serve_soak.main(args + ["--update-baseline"]) == 0
    baseline = json.loads(base.read_text())
    assert (baseline["device"], baseline["p99_ms"]) == ("cpu", ok["p99_ms"])
    assert (tmp_path / "ts.csv").read_text().startswith("t_s,p99_ms,qps,hit_rate,bytes_cached")
    slow = dict(ok, p99_ms=baseline["p99_ms"] * 5)
    assert [n for n, _ in serve_soak.check(slow, baseline)] == ["p99"]
    assert serve_soak.check(slow, dict(baseline, device="cuda")) == []   # not comparable
    assert [n for n, _ in serve_soak.check(dict(ok, bytes_ok=False), baseline)] == ["bytes"]
    monkeypatch.setattr(serve_soak, "soak", lambda *a: slow)
    assert serve_soak.main(args) == 1

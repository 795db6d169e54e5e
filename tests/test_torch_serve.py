"""The port's serving engine and launcher held against the reference.

The same int8 parameters (drawn and quantized by the JAX package, carried
across by ``params_from_jax``) and the same request stream go to the JAX
``RecsysEngine`` (no mesh, cache off) and to the port's engine (CPU, the
kernel route on, so the kernels' plain versions).  Scores agree within
1e-4 — f32 summation order through pooling, interaction and two MLPs, the
reference's own engine bound (``tests/test_serve_quant.py:336``) — and
both engines form the same waves and buckets.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import EmbeddingSpec as JSpec
from repro.models.dlrm import DLRMConfig as JCfg
from repro.models.dlrm import dlrm_init as jax_dlrm_init
from repro.serve.quantize import quantize_params as jax_quantize_params
from repro.serve.recsys import RecsysEngine as JaxEngine
from repro_torch.convert import params_from_jax
from repro_torch.core import EmbeddingSpec as TSpec
from repro_torch.launch import serve as launch_serve
from repro_torch.models.dlrm import DLRMConfig as TCfg
from repro_torch.serve.cache import DeviceHotRowCache
from repro_torch.serve.recsys import RecsysEngine

SIZES = (100, 500, 33)


def _cfgs():
    base = dict(table_sizes=SIZES, emb_dim=16, bottom_mlp=(32, 16), top_mlp=(32,))
    spec = dict(kind="qr", num_collisions=4, threshold=40)
    return (JCfg(embedding=JSpec(**spec), **base),
            TCfg(embedding=TSpec(**spec), use_kernel=True, **base))


def _requests(n, seed):
    rng = np.random.default_rng(seed)
    reqs = [(rng.normal(size=13),
             [list(rng.integers(0, s, size=rng.integers(0, 4))) for s in SIZES])
            for _ in range(n)]
    for k in range(4, 8):                       # one all-empty wave at max_batch=4
        reqs[k] = (reqs[k][0], [[] for _ in SIZES])
    return reqs


@pytest.mark.parametrize("batching", ["continuous", "waves"])
def test_engine_matches_reference_engine(batching):
    jcfg, tcfg = _cfgs()
    jp = jax_quantize_params(jax_dlrm_init(jax.random.PRNGKey(0), jcfg))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    reqs = _requests(22, seed=1)
    jeng = JaxEngine(jcfg, jp, max_batch=4, batching=batching)
    teng = RecsysEngine(tcfg, tp, max_batch=4, batching=batching, device="cpu")
    ju = [jeng.submit(d, b) for d, b in reqs]
    tu = [teng.submit(d, b) for d, b in reqs]
    jdone, tdone = jeng.run_until_drained(), teng.run_until_drained()
    got = np.array([tdone[u].score for u in tu])
    want = np.array([jdone[u].score for u in ju])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    jm, tm = jeng.metrics(), teng.metrics()
    assert tm["buckets"] == jm["buckets"]
    assert (tm["requests"], tm["waves"]) == (jm["requests"], jm["waves"])
    assert tm["batching"] == batching
    if batching == "waves":
        assert (4, 1) in tm["buckets"]          # the all-empty wave floored at Lb=1


def test_engine_refuses_what_is_not_ported():
    _, tcfg = _cfgs()
    params = {"tables": [], "bottom": [], "top": []}
    # mesh= takes a named DeviceMesh (the DTensor re-layout); sharded
    # serving needs a process group of mesh_devices ranks
    with pytest.raises(TypeError, match="named DeviceMesh"):
        RecsysEngine(tcfg, params, device="cpu", mesh=object())
    with pytest.raises(RuntimeError, match="none is initialized"):
        RecsysEngine(tcfg, params, max_batch=4, device="cpu", mesh_devices=2)
    # the cache is ported; one whose slabs live on another device is refused
    with pytest.raises(ValueError, match="device"):
        RecsysEngine(tcfg, params, device="cpu", cache=DeviceHotRowCache(8, device="meta"))
    with pytest.raises(NotImplementedError, match="feature"):
        RecsysEngine(TCfg(table_sizes=SIZES, embedding=TSpec(kind="feature")), params,
                     device="cpu")
    with pytest.raises(ValueError):
        RecsysEngine(tcfg, params, device="cpu", batching="nope")


def test_engine_validates_requests():
    _, tcfg = _cfgs()
    from repro_torch.models.dlrm import dlrm_init
    eng = RecsysEngine(tcfg, dlrm_init(tcfg, torch.Generator().manual_seed(0), "cpu"),
                       device="cpu")
    with pytest.raises(ValueError, match="feature bags"):
        eng.submit(np.zeros(13), [[1], [2]])
    with pytest.raises(ValueError, match=r"\[0, 500\)"):
        eng.submit(np.zeros(13), [[1], [500], [2]])
    with pytest.raises(ValueError):
        eng.submit(np.zeros(13), [[-1], [0], [2]])
    eng.submit(np.zeros(13), [[], [499], []])
    assert eng.run_until_drained()[0].done


def test_engine_runs_on_the_card_by_default():
    """Entry points default to the card; without one they raise rather
    than fall back to the CPU."""
    _, tcfg = _cfgs()
    from repro_torch.models.dlrm import dlrm_init
    params = dlrm_init(tcfg, torch.Generator().manual_seed(0), "cpu")
    if torch.cuda.is_available():
        assert RecsysEngine(tcfg, params).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            RecsysEngine(tcfg, params)


def test_launcher_main_cpu(capsys):
    done = launch_serve.main(["--device", "cpu", "--requests", "10", "--batch-size", "4"])
    assert len(done) == 10 and all(np.isfinite(r.score) for r in done.values())
    out = capsys.readouterr().out
    assert "dlrm-criteo: served 10 requests" in out and "int8" in out
    assert "cache: hit_rate" in out                 # the device cache is on by default
    done = launch_serve.main(["--device", "cpu", "--requests", "5", "--quantize", "bf16",
                              "--batching", "waves", "--cache-rows", "0"])
    assert len(done) == 5 and "cache:" not in capsys.readouterr().out
    for flags, resident in ((["--cache-rows", "8"], 8 * 16 * 4),
                            (["--cache-mb", "1"], None), (["--cache-impl", "host"], None),
                            (["--arch", "dcn-criteo"], None)):
        done = launch_serve.main(["--device", "cpu", "--requests", "6", *flags])
        assert len(done) == 6 and all(np.isfinite(r.score) for r in done.values())
        out = capsys.readouterr().out
        assert "cache: hit_rate" in out, flags
        if resident is not None:
            assert f", {resident} B resident" in out
    assert "dcn-criteo: served 6 requests" in out


def test_request_stream_matches_reference_launcher_draws():
    """The port's stream reproduces the reference launcher's numpy draws
    (``launch/serve.py`` rec branch): same dense rows, bag lengths and ids."""
    sizes = (1000, 31, 3)
    got = list(launch_serve.request_stream(np.random.default_rng(0), sizes, 13, 5, 4))
    rng = np.random.default_rng(0)
    for dense, bags in got:
        np.testing.assert_array_equal(dense, rng.normal(size=13))
        for s, bag in zip(sizes, bags):
            ln = int(rng.integers(1, 5))
            want = np.floor((rng.random(ln) ** 1.5) * s).astype(np.int64)
            assert bag == list(want)

"""``RecsysEngine(mesh=)`` — the parameters laid out as DTensors by the
inference placement, the dense stage on DTensors, the kernels on plain
tensors — held against the unmeshed engine and the JAX package's engine.

A gloo world of 4 on the CPU (``dist.world.spawn``) serves the reduced
int8 DLRM-Criteo on a ``(data=2, model=2)`` mesh (tables row-split over
``model``, the MLPs' output columns over ``model``, each wave's rows over
``data``), with the kernels' routes (``use_kernel=True``: K4 and K2, whose
plain versions run on CPU tensors) and without.  Its scores match the
port's unmeshed engine and the reference's unmeshed ``RecsysEngine`` on
the same parameters and requests within 1e-5: the split contractions of
the MLPs sum their f32 partial products in another order.  A world of 1
(``(1, 1)``) is bit-equal to the unmeshed engine.

The same worlds serve through the hot-row cache (``DeviceHotRowCache``,
whose waves take the fast, exact and in-graph branches on this stream,
and the host ``HotRowCache``): the cache's statistics and branches equal
the unmeshed cached engine's, the scores are bit-equal at ``(1, 1)`` and
within 1e-5 at ``(2, 2)``, where they also hold within 1e-5 to the JAX
package's single-device cached engine.  ``swap_plan`` on a meshed engine
(cached or not) installs a c=2 plan laid out on the mesh.
"""

import dataclasses
import functools
import os
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.configs import dlrm_criteo
from repro_torch.configs.common import embedding_spec
from repro_torch.dist import world
from repro_torch.serve import quantize as tquant
from repro_torch.serve.cache import DeviceHotRowCache, HotRowCache
from repro_torch.serve.recsys import _CACHE_PATHS, RecsysEngine

REQUESTS = 96
TOL = 1e-5
# a cache this small refuses the admission of the waves of long bags (served
# in-graph), admits the others (exact), and holds the last wave's rows, so
# that wave served again comes from the slab (fast)
CACHE_ROWS = 512
CACHE_KINDS = ("device", "host")
STATS = ("hits", "misses", "evictions", "insertions", "rejections", "invalidations",
         "bytes_cached", "lookups")
SWAP_REQUESTS = 32


def _cfg(kernel, c=4):
    return dataclasses.replace(dlrm_criteo.config(reduced=True), emb_dim=16, use_kernel=kernel,
                               embedding=embedding_spec("qr", c))


def _params(cfg, seed=0):
    params = dlrm_criteo.api(cfg, device="cpu").init(torch.Generator().manual_seed(seed))
    return params, tquant.quantize_params(params, mode="int8")


def _stream(cfg, count, max_bag=6):
    """Bag lengths varied per request, every 4th request with an empty bag."""
    r = np.random.default_rng(3)
    reqs = []
    for k in range(count):
        length = 1 + (k * 5) % max_bag
        dense = r.normal(size=(13,)).astype(np.float32)
        bags = [list(r.integers(0, s, size=length).astype(int)) for s in cfg.table_sizes]
        if k % 4 == 1:
            bags[k % len(bags)] = []
        reqs.append((dense, bags))
    return reqs


def _scores(engine, reqs):
    uids = [engine.submit(d, b) for d, b in reqs]
    done = engine.run_until_drained()
    return np.asarray([done[u].score for u in uids], np.float32)


def _cached_stream(cfg):
    reqs = _stream(cfg, REQUESTS)
    return reqs + reqs[-16:]


def _swap(engine):
    """``swap_plan`` onto a c=2 plan of other weights, then serve: the
    swapped scores."""
    cfg = _cfg(engine.cfg.use_kernel, c=2)
    engine.swap_plan(cfg, _params(cfg, seed=1)[1])
    return _scores(engine, _stream(cfg, SWAP_REQUESTS))


def _cached_lane(kind, **kw):
    """The kernel route through a ``kind`` cache of ``CACHE_ROWS`` rows:
    scores, cache statistics, branch counts and the mesh's gathered bytes
    of the cached stream, then the scores after ``_swap``."""
    cfg = _cfg(True)
    cache = DeviceHotRowCache(CACHE_ROWS, device="cpu") if kind == "device" \
        else HotRowCache(CACHE_ROWS)
    engine = RecsysEngine(cfg, _params(cfg)[1], max_batch=16, cache=cache, device="cpu", **kw)
    scores = _scores(engine, _cached_stream(cfg))
    m = engine.metrics()
    return {"scores": scores, "stats": np.array([m["cache"][k] for k in STATS]),
            "paths": np.array([m["cache_paths"][k] for k in _CACHE_PATHS]),
            "gather": np.array(m.get("mesh", {}).get("gather_bytes", 0)),
            "swapped": _swap(engine)}


def _mesh_world(rank, world_size, shape, out_dir):
    from repro_torch.launch.mesh import make_local_mesh

    torch.set_num_threads(1)
    mesh = make_local_mesh(*shape)
    res = {}
    for kernel in (True, False):
        cfg = _cfg(kernel)
        _, qp = _params(cfg)
        engine = RecsysEngine(cfg, qp, max_batch=16, mesh=mesh, device="cpu")
        res[f"scores/{int(kernel)}"] = _scores(engine, _stream(cfg, REQUESTS))
        res[f"gather/{int(kernel)}"] = np.array(engine.metrics()["mesh"]["gather_bytes"])
        res[f"local_rows/{int(kernel)}"] = np.array(
            engine.params["tables"][0]["table_0"]["q"].to_local().shape[0])
        if not kernel:
            res["swapped/0"] = _swap(engine)
            res["swapped_local_rows/0"] = np.array(
                engine.params["tables"][0]["table_0"]["q"].to_local().shape[0])
    for kind in CACHE_KINDS:
        res.update({f"{k}/{kind}": v for k, v in _cached_lane(kind, mesh=mesh).items()})
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


def _world(shape):
    with tempfile.TemporaryDirectory() as d:
        world.spawn(_mesh_world, int(np.prod(shape)), "gloo", shape, d)
        return [dict(np.load(os.path.join(d, f"rank{r}.npz")))
                for r in range(int(np.prod(shape)))]


def _unmeshed(kernel):
    cfg = _cfg(kernel)
    _, qp = _params(cfg)
    return _scores(RecsysEngine(cfg, qp, max_batch=16, device="cpu"), _stream(cfg, REQUESTS))


@functools.lru_cache(maxsize=None)
def _unmeshed_cached(kind):
    return _cached_lane(kind)


@functools.lru_cache(maxsize=None)
def _unmeshed_swapped():
    cfg = _cfg(False)
    engine = RecsysEngine(cfg, _params(cfg)[1], max_batch=16, device="cpu")
    _scores(engine, _stream(cfg, REQUESTS))
    return _swap(engine)


def _reference(kernel):
    """The JAX package's unmeshed engine (its plain route) on the same
    parameters (drawn by the port, carried as numpy) and requests.  JAX is
    imported here, not at the top: the spawned ranks import this module."""
    import jax
    import jax.numpy as jnp

    from repro.configs import dlrm_criteo as jdlrm
    from repro.serve import quantize as jquant
    from repro.serve.recsys import RecsysEngine as JEngine
    cfg = _cfg(kernel)
    params, _ = _params(cfg)
    jparams = jax.tree.map(lambda x: jnp.asarray(x.numpy()), params)
    jq = jquant.quantize_params(jparams, mode="int8")
    jcfg = dataclasses.replace(jdlrm.config(reduced=True), emb_dim=16, use_kernel=False)
    return _scores(JEngine(jcfg, jq, max_batch=16), _stream(cfg, REQUESTS))


@pytest.fixture(scope="module")
def reference_cached():
    """The JAX package's single-device engine through each kind of cache
    (its plain route), on ``_cached_lane``'s parameters and requests.  Its
    device cache records events, so every wave takes the exact branch:
    the same scores with fewer programs to compile than the fast probe's."""
    import jax
    import jax.numpy as jnp

    from repro.configs import dlrm_criteo as jdlrm
    from repro.serve import cache as jcache
    from repro.serve import quantize as jquant
    from repro.serve.recsys import RecsysEngine as JEngine
    cfg = _cfg(True)
    params, _ = _params(cfg)
    jq = jquant.quantize_params(jax.tree.map(lambda x: jnp.asarray(x.numpy()), params),
                                mode="int8")
    jcfg = dataclasses.replace(jdlrm.config(reduced=True), emb_dim=16, use_kernel=False)
    caches = {"device": jcache.DeviceHotRowCache(CACHE_ROWS, record_events=True),
              "host": jcache.HotRowCache(CACHE_ROWS)}
    return {kind: _scores(JEngine(jcfg, jq, max_batch=16, cache=caches[kind]),
                          _cached_stream(cfg)) for kind in CACHE_KINDS}


@pytest.fixture(scope="module")
def world4():
    return _world((2, 2))


@pytest.fixture(scope="module")
def world1():
    return _world((1, 1))[0]


@pytest.mark.parametrize("kernel", [True, False])
def test_mesh_2x2_matches_unmeshed_and_reference(world4, kernel):
    one = _unmeshed(kernel)
    ref = _reference(kernel)
    assert np.isfinite(one).all() and len(one) == REQUESTS
    np.testing.assert_allclose(one, ref, rtol=0, atol=TOL)
    for rank in world4:
        got = rank[f"scores/{int(kernel)}"]
        np.testing.assert_allclose(got, one, rtol=0, atol=TOL)
        np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    # every rank returns the whole wave's scores, the same on each
    for rank in world4[1:]:
        np.testing.assert_array_equal(rank[f"scores/{int(kernel)}"],
                                      world4[0][f"scores/{int(kernel)}"])


def test_mesh_2x2_splits_tables_and_counts_the_gather(world4):
    cfg = _cfg(True)
    _, qp = _params(cfg)
    rows = qp["tables"][0]["table_0"]["q"].shape[0]
    for rank in world4:
        for kernel in (1, 0):
            # the first table's rows split over model = 2 (the rule table's
            # ("model", None)); the kernels gather them whole every wave
            assert int(rank[f"local_rows/{kernel}"]) == rows // 2
            assert int(rank[f"gather/{kernel}"]) > 0


def test_mesh_1x1_is_bit_equal_to_unmeshed(world1):
    res = world1
    for kernel in (True, False):
        np.testing.assert_array_equal(res[f"scores/{int(kernel)}"], _unmeshed(kernel))
        assert int(res[f"gather/{int(kernel)}"]) == 0


def test_the_cached_stream_takes_every_branch():
    paths = dict(zip(_CACHE_PATHS, _unmeshed_cached("device")["paths"].tolist()))
    assert paths["fast"] and paths["exact"] and paths["ingraph"] and not paths["host"]
    assert dict(zip(_CACHE_PATHS, _unmeshed_cached("host")["paths"].tolist()))["host"]


@pytest.mark.parametrize("kind", CACHE_KINDS)
def test_mesh_1x1_cached_is_bit_equal_to_unmeshed_cached(world1, kind):
    """A (1, 1) mesh through the cache runs the unmeshed cached engine's
    work: the same scores, statistics and branches, and its swap."""
    one = _unmeshed_cached(kind)
    for key in ("scores", "stats", "paths", "swapped"):
        np.testing.assert_array_equal(world1[f"{key}/{kind}"], one[key], err_msg=key)
    assert int(world1[f"gather/{kind}"]) == 0


@pytest.mark.parametrize("kind", CACHE_KINDS)
def test_mesh_2x2_cached_matches_unmeshed_and_reference(world4, reference_cached, kind):
    """At (2, 2) the cache computes its rows from the gathered tables: the
    statistics and branches are the unmeshed cached engine's, the scores
    within 1e-5 of it and of the JAX package's cached engine, and the swap
    serves the new plan within 1e-5."""
    one, ref = _unmeshed_cached(kind), reference_cached[kind]
    np.testing.assert_allclose(one["scores"], ref, rtol=0, atol=TOL)
    for rank in world4:
        got = rank[f"scores/{kind}"]
        assert np.isfinite(got).all() and len(got) == len(ref)
        np.testing.assert_allclose(got, one["scores"], rtol=0, atol=TOL)
        np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
        np.testing.assert_array_equal(rank[f"stats/{kind}"], one["stats"])
        np.testing.assert_array_equal(rank[f"paths/{kind}"], one["paths"])
        np.testing.assert_allclose(rank[f"swapped/{kind}"], one["swapped"], rtol=0, atol=TOL)
        assert int(rank[f"gather/{kind}"]) > 0
    for rank in world4[1:]:
        np.testing.assert_array_equal(rank[f"scores/{kind}"], world4[0][f"scores/{kind}"])


def test_mesh_swap_plan_without_cache(world1, world4):
    """``swap_plan`` on the uncached meshed engine: the c=2 tables laid out
    on the mesh (rows split over model = 2 at (2, 2)), scores bit-equal to
    the unmeshed swap at (1, 1) and within 1e-5 at (2, 2)."""
    want = _unmeshed_swapped()
    cfg = _cfg(False, c=2)
    rows = _params(cfg, seed=1)[1]["tables"][0]["table_0"]["q"].shape[0]
    assert rows != _params(_cfg(False))[1]["tables"][0]["table_0"]["q"].shape[0]
    np.testing.assert_array_equal(world1["swapped/0"], want)
    assert int(world1["swapped_local_rows/0"]) == rows
    for rank in world4:
        np.testing.assert_allclose(rank["swapped/0"], want, rtol=0, atol=TOL)
        assert int(rank["swapped_local_rows/0"]) == rows // 2


def test_mesh_and_mesh_devices_together_raise():
    cfg = _cfg(True)
    _, qp = _params(cfg)
    with pytest.raises(ValueError, match="give one"):
        RecsysEngine(cfg, qp, mesh=object(), mesh_devices=2, device="cpu")

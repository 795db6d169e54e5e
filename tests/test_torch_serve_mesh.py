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
"""

import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.configs import dlrm_criteo
from repro_torch.dist import world
from repro_torch.serve import quantize as tquant
from repro_torch.serve.recsys import RecsysEngine

REQUESTS = 96
TOL = 1e-5


def _cfg(kernel):
    return dataclasses.replace(dlrm_criteo.config(reduced=True), emb_dim=16, use_kernel=kernel)


def _params(cfg):
    params = dlrm_criteo.api(cfg, device="cpu").init(torch.Generator().manual_seed(0))
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
def world4():
    return _world((2, 2))


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


def test_mesh_1x1_is_bit_equal_to_unmeshed():
    res = _world((1, 1))[0]
    for kernel in (True, False):
        np.testing.assert_array_equal(res[f"scores/{int(kernel)}"], _unmeshed(kernel))
        assert int(res[f"gather/{int(kernel)}"]) == 0


def test_mesh_and_mesh_devices_together_raise():
    cfg = _cfg(True)
    _, qp = _params(cfg)
    with pytest.raises(ValueError, match="give one"):
        RecsysEngine(cfg, qp, mesh=object(), mesh_devices=2, device="cpu")

"""The port's DCN held against the reference: JAX-initialised parameters
carried across by ``params_from_jax`` give the same logits, loss, metrics
and gradients, one-hot and multi-hot, for several table kinds; the
parameter layout and one AMSGrad train step (the config's optimizer)
match too.

Tolerances: logits 1e-4 (f32 summation order through the cross layers and
two MLPs, as ``test_torch_dlrm.py``); loss and gradients f32 1e-5, the
gradients relative to each leaf's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dcn_criteo as jdcn_criteo
from repro.core import EmbeddingSpec as JSpec
from repro.models import dcn as jdcn
from repro.train import loop as jloop
from repro_torch import tree
from repro_torch.configs import dcn_criteo
from repro_torch.convert import params_from_jax, state_from_jax, state_to_numpy
from repro_torch.core import EmbeddingSpec as TSpec
from repro_torch.models import dcn as tdcn
from repro_torch.train import loop as tloop

SIZES = (100, 500, 33, 2000)
KINDS = {
    "qr": dict(kind="qr", num_collisions=4, threshold=40),
    "qr_concat": dict(kind="qr", num_collisions=4, op="concat"),
    "hash": dict(kind="hash", num_collisions=8),
    "full": dict(kind="full"),
    "feature": dict(kind="feature", num_collisions=4),
    "path": dict(kind="path", num_collisions=4, path_hidden=8),
}


def _cfgs(spec_kw):
    base = dict(table_sizes=SIZES, emb_dim=8, cross_layers=3, deep_mlp=(32, 16))
    return (jdcn.DCNConfig(embedding=JSpec(**spec_kw), **base),
            tdcn.DCNConfig(embedding=TSpec(**spec_kw), **base))


def _both(jcfg):
    jp = jdcn.dcn_init(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _batch(b=12, length=3, seed=0):
    rng = np.random.default_rng(seed)
    return {"dense": rng.normal(size=(b, 13)).astype(np.float32),
            "sparse": np.stack([rng.integers(0, s, size=b) for s in SIZES],
                               axis=1).astype(np.int32),
            "multi": np.stack([rng.integers(0, s, size=(b, length)) for s in SIZES],
                              axis=1).astype(np.int32),
            "mask": (rng.random((b, len(SIZES), length)) > 0.3).astype(np.float32),
            "label": (rng.random(b) > 0.5).astype(np.float32)}


def _assert_leaves_close(jtree, ttree, tol):
    jl = [np.asarray(x, np.float32) for x in jax.tree.leaves(jtree)]
    tl = tree.leaves(state_to_numpy(ttree))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=tol * max(1.0, float(np.abs(a).max())))


@pytest.mark.parametrize("kind", list(KINDS))
def test_forward_matches_reference(kind):
    jcfg, tcfg = _cfgs(KINDS[kind])
    jp, tp = _both(jcfg)
    b = _batch()
    want = jdcn.dcn_forward(jp, jnp.asarray(b["dense"]), jnp.asarray(b["sparse"]), jcfg)
    got = tdcn.dcn_forward(tp, torch.from_numpy(b["dense"]), torch.from_numpy(b["sparse"]),
                           tcfg)
    assert got.shape == (12,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    if kind not in ("path", "feature"):  # neither has a multi-hot route in the reference
        want = jdcn.dcn_forward(jp, jnp.asarray(b["dense"]), jnp.asarray(b["multi"]), jcfg,
                                mask=jnp.asarray(b["mask"]))
        got = tdcn.dcn_forward(tp, torch.from_numpy(b["dense"]), torch.from_numpy(b["multi"]),
                               tcfg, mask=torch.from_numpy(b["mask"]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", list(KINDS))
def test_loss_metrics_and_gradients_match_reference(kind):
    jcfg, tcfg = _cfgs(KINDS[kind])
    jp, tp = _both(jcfg)
    b = _batch(seed=1)
    batch = {k: b[k] for k in ("dense", "sparse", "label")}
    (jloss, jm), jg = jax.value_and_grad(lambda p, x: jdcn.dcn_loss_fn(p, x, jcfg),
                                         has_aux=True)(jp, {k: jnp.asarray(v)
                                                            for k, v in batch.items()})
    (tloss, tm), tg = tloop.value_and_grad(lambda p, x: tdcn.dcn_loss_fn(p, x, tcfg))(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert float(tm["acc"]) == float(jm["acc"])
    _assert_leaves_close(jg, tg, 1e-5)


def test_init_layout_matches_reference():
    jcfg, tcfg = _cfgs(KINDS["qr"])
    jp = jax.tree.map(np.asarray, jdcn.dcn_init(jax.random.PRNGKey(0), jcfg))
    tp = tdcn.dcn_init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == len(tree.leaves(tp))
    for (path, leaf), (tpath, tleaf) in zip(flat, tree.flatten_with_path(tp)):
        assert tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path) == tpath
        assert tuple(tleaf.shape) == leaf.shape and str(tleaf.dtype) == f"torch.{leaf.dtype}"
    d0 = 13 + 8 * len(SIZES)
    assert float(tp["cross"][0]["w"].std()) == pytest.approx((1 / d0) ** 0.5, rel=0.5)


def test_amsgrad_train_step_matches_reference():
    """One step with the config's optimizer (AMSGrad 1e-3) on the reduced
    DCN-Criteo: loss, metrics and optimizer state (``m``, ``v``, ``vmax``,
    each linear or quadratic in the gradient) within 1e-5.  The parameters
    are not compared: a first Adam step is ``-lr * g / (|g| + 1e-8)``, so
    an element whose gradient is roundoff-sized on either side moves by up
    to ``lr`` apart (``test_torch_optim.py`` holds the update itself on
    equal gradients)."""
    jcfg = jdcn_criteo.config(reduced=True)
    japi = jdcn_criteo.api(jcfg)
    tapi = dcn_criteo.api(dcn_criteo.config(reduced=True), device="cpu")
    jstate = jloop.init_state(japi.init(jax.random.PRNGKey(2)), japi.optimizer)
    tstate = state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    b = _batch(b=32, seed=2)
    rng = np.random.default_rng(3)
    b["sparse"] = np.stack([rng.integers(0, s, size=32) for s in jcfg.table_sizes],
                           axis=1).astype(np.int32)
    batch = {k: b[k] for k in ("dense", "sparse", "label")}
    jstep = jax.jit(jloop.make_train_step(japi.loss_fn, japi.optimizer))
    jnew, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tnew, tm = tloop.make_train_step(tapi.loss_fn, tapi.optimizer)(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    _assert_leaves_close(jnew["opt"], tnew["opt"], 1e-5)
    assert int(tnew["step"]) == int(jnew["step"]) == 1

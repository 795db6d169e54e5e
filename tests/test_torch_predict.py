"""One-hot scoring held against the reference: ``dlrm_forward`` with
``use_kernel=True`` (every QR pair through ``ops.qr_lookup``, the
interaction through K2) and ``api(cfg).loss_fn`` / ``predict`` give the
reference's logits and loss, with the reference running its Pallas kernels
in interpret mode.  Parameters are the reference's ``init`` carried across
by ``params_from_jax``, and the batches the reference's ``batch_fn``
(``batch_at(0, step)`` with ``zipf=1.5, noise=0.5``), at reduced widths, on
f32, bf16 and int8 tables.

Tolerances: logits and loss 1e-4 with f32 and int8 tables (f32 summation
order through the interaction and two MLPs, as ``test_torch_dlrm.py``);
3e-2 with bf16 tables.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import dlrm_criteo as jconfig
from repro.configs.common import Shape as JShape
from repro.serve.quantize import quantize_params as jax_quantize_params
from repro_torch.configs import dlrm_criteo as tconfig
from repro_torch.configs.common import Shape
from repro_torch.convert import params_from_jax
from repro_torch.models import dlrm as tdlrm

SIZES = (100, 500, 33, 2000, 7)
TOL = {"f32": 1e-4, "int8": 1e-4, "bf16": 3e-2}


def _apis(use_kernel=True):
    kw = dict(table_sizes=SIZES, emb_dim=8, bottom_mlp=(32, 8), top_mlp=(32, 16),
              use_kernel=use_kernel)
    jcfg = dataclasses.replace(jconfig.config(reduced=True), **kw)
    tcfg = dataclasses.replace(tconfig.config(reduced=True), **kw)
    return jconfig.api(jcfg), tconfig.api(tcfg, device="cpu")


def _params(japi, mode):
    jp = japi.init(jax.random.PRNGKey(0))
    if mode != "f32":
        jp = jax_quantize_params(jp, mode=mode)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _batch(japi, step, b=16):
    jb = japi.batch_fn(step, JShape("bench", 1, b, "train"))
    return jb, {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_one_hot_kernel_route_matches_reference(mode):
    japi, tapi = _apis()
    jp, tp = _params(japi, mode)
    for step in (10_000, 10_001):
        jb, tb = _batch(japi, step)
        want = japi.predict(jp, jb)
        got = tapi.predict(tp, tb)
        assert got.shape == (16,) and torch.isfinite(got).all()
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=TOL[mode], atol=TOL[mode])
        jloss, jm = japi.loss_fn(jp, jb)
        tloss, tm = tapi.loss_fn(tp, tb)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL[mode], atol=TOL[mode])
        np.testing.assert_allclose(float(tm["bce"]), float(jm["bce"]), rtol=TOL[mode],
                                   atol=TOL[mode])
        if mode != "bf16":
            assert float(tm["acc"]) == float(jm["acc"])


@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_kernel_route_equals_plain_route(mode):
    """The scoring route with and without use_kernel: the same logits
    within 1e-4, as chip_smoke.py holds the card's run."""
    japi, tapi = _apis()
    _, plain_api = _apis(use_kernel=False)
    _, tp = _params(japi, mode)
    _, tb = _batch(japi, 10_002)
    torch.testing.assert_close(tapi.predict(tp, tb), plain_api.predict(tp, tb), rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(tapi.loss_fn(tp, tb)[0], plain_api.loss_fn(tp, tb)[0],
                               rtol=1e-4, atol=1e-4)


def test_one_hot_forward_with_int64_ids_and_a_port_batch():
    """The port's own batches (int32 ids) and int64 ids score the same."""
    _, tapi = _apis()
    tp = tapi.init(torch.Generator().manual_seed(0))
    b = tapi.batch_fn(10_000, Shape("bench", 1, 8, "train"))
    logits = tapi.predict(tp, b)
    wide = tdlrm.dlrm_forward(tp, b["dense"], b["sparse"].long(), tapi.cfg)
    torch.testing.assert_close(logits, wide, rtol=0, atol=0)
    assert logits.shape == (8,) and torch.isfinite(logits).all()

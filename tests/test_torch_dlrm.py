"""The port's DLRM held against the reference: JAX-initialised parameters
carried across by ``params_from_jax`` give the same logits and loss,
one-hot and multi-hot, dense, bf16 and int8 tables, with and without the
kernel route (plain versions on the CPU).

Tolerances: f32 logits 1e-4 — f32 summation order through the pooling,
the interaction and two MLPs (the reference's own engine bound,
``tests/test_serve_quant.py:336``); bf16 tables 3e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EmbeddingSpec as JSpec
from repro.models import dlrm as jdlrm
from repro.serve.quantize import quantize_params as jax_quantize_params
from repro_torch.convert import params_from_jax
from repro_torch.core import EmbeddingSpec as TSpec
from repro_torch.models import dlrm as tdlrm

SIZES = (100, 500, 33, 2000)
KINDS = {
    "qr": dict(kind="qr", num_collisions=4, threshold=40),
    "qr_add": dict(kind="qr", num_collisions=4, op="add"),
    "hash": dict(kind="hash", num_collisions=8),
    "full": dict(kind="full"),
    "mixed_radix": dict(kind="mixed_radix"),
    "path": dict(kind="path", num_collisions=4, path_hidden=8),
}


def _cfgs(spec_kw, use_kernel=False, param_dtype="float32"):
    base = dict(table_sizes=SIZES, emb_dim=8, bottom_mlp=(32, 8), top_mlp=(32, 16),
                use_kernel=use_kernel, param_dtype=param_dtype)
    return (jdlrm.DLRMConfig(embedding=JSpec(**spec_kw), **base),
            tdlrm.DLRMConfig(embedding=TSpec(**spec_kw), **base))


def _batch(b=6, length=3, seed=0):
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(b, 13)).astype(np.float32)
    one_hot = np.stack([rng.integers(0, s, size=b) for s in SIZES], axis=1).astype(np.int32)
    multi = np.stack([rng.integers(0, s, size=(b, length)) for s in SIZES],
                     axis=1).astype(np.int32)
    mask = (rng.random((b, len(SIZES), length)) > 0.3).astype(np.float32)
    mask[0] = 0.0                                        # every bag empty
    label = (rng.random(b) > 0.5).astype(np.float32)
    return dense, one_hot, multi, mask, label


def _both_params(jcfg, quant=None):
    jp = jdlrm.dlrm_init(jax.random.PRNGKey(0), jcfg)
    if quant:
        jp = jax_quantize_params(jp, mode=quant)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _compare(jp, tp, jcfg, tcfg, tol, sparse, mask=None, dense=None):
    want = jdlrm.dlrm_forward(jp, jnp.asarray(dense), jnp.asarray(sparse), jcfg,
                              mask=None if mask is None else jnp.asarray(mask))
    got = tdlrm.dlrm_forward(tp, torch.from_numpy(dense), torch.from_numpy(sparse), tcfg,
                             mask=None if mask is None else torch.from_numpy(mask))
    assert got.shape == (dense.shape[0],)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("kind", list(KINDS))
def test_forward_matches_reference(kind):
    jcfg, tcfg = _cfgs(KINDS[kind])
    jp, tp = _both_params(jcfg)
    dense, one_hot, multi, mask, _ = _batch()
    _compare(jp, tp, jcfg, tcfg, 1e-4, one_hot, dense=dense)
    if kind != "path":  # the reference's bag_pool passes path-based apply a
        # gather= it does not take, so it has no multi-hot path-based route
        _compare(jp, tp, jcfg, tcfg, 1e-4, multi, mask=mask, dense=dense)


@pytest.mark.parametrize("quant,tol", [("int8", 1e-4), ("bf16", 3e-2)])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_quantized_multihot_matches_reference(quant, tol, use_kernel):
    jcfg, tcfg = _cfgs(KINDS["qr"], use_kernel=use_kernel)
    jp, tp = _both_params(jcfg, quant=quant)
    dense, _, multi, mask, _ = _batch(seed=1)
    _compare(jp, tp, jcfg, tcfg, tol, multi, mask=mask, dense=dense)


def test_kernel_route_equals_plain_route():
    """use_kernel on the CPU takes the kernels' plain versions: the same
    logits as the plain model route, one-hot (the bf16 param case too)."""
    for param_dtype, tol in (("float32", 1e-5), ("bfloat16", 3e-2)):
        jcfg, tcfg = _cfgs(KINDS["qr"], param_dtype=param_dtype)
        _, tp = _both_params(jcfg)
        dense, one_hot, multi, mask, _ = _batch(seed=2)
        kcfg = dataclasses.replace(tcfg, use_kernel=True)
        for sparse, mk in ((one_hot, None), (multi, mask)):
            args = (torch.from_numpy(dense), torch.from_numpy(sparse))
            kw = {"mask": None if mk is None else torch.from_numpy(mk)}
            torch.testing.assert_close(tdlrm.dlrm_forward(tp, *args, kcfg, **kw).float(),
                                       tdlrm.dlrm_forward(tp, *args, tcfg, **kw).float(),
                                       rtol=tol, atol=tol)


def test_loss_and_num_params_match_reference():
    for kind in KINDS:
        jcfg, tcfg = _cfgs(KINDS[kind])
        assert tdlrm.dlrm_num_params(tcfg) == jdlrm.dlrm_num_params(jcfg)
    jcfg, tcfg = _cfgs(KINDS["qr"])
    jp, tp = _both_params(jcfg)
    dense, one_hot, _, _, label = _batch(b=16, seed=3)
    jloss, jm = jdlrm.dlrm_loss_fn(jp, {"dense": jnp.asarray(dense),
                                        "sparse": jnp.asarray(one_hot),
                                        "label": jnp.asarray(label)}, jcfg)
    tloss, tm = tdlrm.dlrm_loss_fn(tp, {"dense": torch.from_numpy(dense),
                                        "sparse": torch.from_numpy(one_hot),
                                        "label": torch.from_numpy(label)}, tcfg)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert float(tm["acc"]) == float(jm["acc"])
    # the stable form stays finite where the naive one overflows
    big = {"dense": torch.from_numpy(dense * 1e4), "sparse": torch.from_numpy(one_hot),
           "label": torch.from_numpy(label)}
    assert torch.isfinite(tdlrm.dlrm_loss_fn(tp, big, tcfg)[0])


def test_init_layout_matches_reference():
    jcfg, tcfg = _cfgs(KINDS["qr"])
    jp = jax.tree.map(np.asarray, jdlrm.dlrm_init(jax.random.PRNGKey(0), jcfg))
    tp = tdlrm.dlrm_init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    jshapes = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in jshapes:
        node = tp
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        assert tuple(node.shape) == leaf.shape and str(node.dtype).endswith(str(leaf.dtype))


def test_one_hot_qr_kernel_route_on_card_is_refused():
    """The one-hot QR kernel route goes through the K1 wrapper, which never
    takes the plain version for a tensor off the CPU.  With no card here,
    tensors on the meta device stand in for one: the kernel route raises
    instead of computing, and the plain route stays plain on any device."""
    _, tcfg = _cfgs(KINDS["qr"], use_kernel=True)
    tp = tdlrm.dlrm_init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    tables = [{k: v.to("meta") for k, v in t.items()} for t in tp["tables"]]
    idx = torch.zeros((2, len(SIZES)), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        tdlrm.embed_features(tables, idx, tcfg)
    feats = tdlrm.embed_features(tables, idx, dataclasses.replace(tcfg, use_kernel=False))
    assert [tuple(f.shape) for f in feats] == [(2, 8)] * len(SIZES)

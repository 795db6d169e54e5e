"""The port's MoE and MLA blocks (``repro_torch.nn.moe``, ``nn.mla``) held
against the JAX package's on the CPU: weights from the reference's
``moe_init`` / ``mla_init`` carried across by ``params_from_jax``, inputs
numpy from a seed.

Tolerances are the reference's own: f32 rtol 1e-4 / atol 1e-5 (its MoE
oracle, ``tests/test_layers.py``), bf16 3e-2 of each tensor's largest
magnitude (one rounding to bf16 at the end of products summed in another
order).  Routes are compared exactly: the top-k experts against
``lax.top_k`` of the reference's softmax, the lower index first on a tie,
and the dropped routes through the rows they zero.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import mla as jmla
from repro.nn import moe as jmoe
from repro_torch import tree
from repro_torch.convert import params_from_jax
from repro_torch.nn import mla as tmla
from repro_torch.nn import moe as tmoe

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = 3e-2


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    x = x.detach() if isinstance(x, torch.Tensor) else x
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float64)


def _close(got, want, dtype):
    got, want = _np(got), np.asarray(want, np.float64)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32)
    else:
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(got - want).max() <= BF16 * scale, (np.abs(got - want).max(), scale)


# ---------------------------------------------------------------- MoE


def _moe_case(cfg, dtype, shape=(2, 6, 16), seed=0):
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), cfg, jnp.dtype(dtype))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    return jp, tp, jx, params_from_jax(np.asarray(jx), "cpu")


def _ref_top_k(jp, jx, cfg):
    """The reference's routing decision, token order: lax.top_k of the f32
    softmax, as ``moe_apply`` computes it."""
    logits = jnp.einsum("bsd,de->bse", jx.astype(jnp.float32),
                        jp["router"]["w"].astype(jnp.float32))
    return np.asarray(jax.lax.top_k(jax.nn.softmax(logits, -1), cfg.top_k)[1])


def _port_top_k(tp, tx, cfg):
    b, s, d = tx.shape
    g = math.gcd(b * s, cfg.groups)
    r = tmoe.route(tp, tx.reshape(g, b * s // g, d), cfg, 1)
    return r.idx.reshape(b, s, cfg.top_k).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups", [4, 8, 5])        # g = 4 (divides 12), gcd 4, gcd 1
@pytest.mark.parametrize("capacity_factor", [8.0, 1.0, 0.25])
def test_moe_apply_matches_the_reference(dtype, groups, capacity_factor):
    cfg = jmoe.MoEConfig(n_experts=8, top_k=2, d_model=16, d_ff=32, groups=groups,
                         capacity_factor=capacity_factor)
    tcfg = tmoe.MoEConfig(n_experts=8, top_k=2, d_model=16, d_ff=32, groups=groups,
                          capacity_factor=capacity_factor)
    jp, tp, jx, tx = _moe_case(cfg, dtype)
    apply = jax.jit(functools.partial(jmoe.moe_apply, cfg=cfg, compute_dtype=jnp.dtype(dtype)))
    want, want_aux = apply(jp, jx)
    got, aux = tmoe.moe_apply(tp, tx, tcfg, getattr(torch, dtype))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_array_equal(_port_top_k(tp, tx, tcfg), _ref_top_k(jp, jx, cfg))
    _close(got, np.asarray(want.astype(jnp.float32)), dtype)
    assert aux.dtype == torch.float32 and float(aux) > 0
    np.testing.assert_allclose(float(aux), float(want_aux), **F32)


def test_moe_capacity_drops_the_same_routes():
    # the reference's capacity case: 2 experts, top-1, one group of 16, cap 2:
    # every route past an expert's second is dropped and its row is exactly 0
    cfg = jmoe.MoEConfig(n_experts=2, top_k=1, d_model=8, d_ff=16, groups=1,
                         capacity_factor=0.25)
    tcfg = tmoe.MoEConfig(**vars(cfg))
    jp, tp, jx, tx = _moe_case(cfg, "float32", shape=(1, 16, 8), seed=4)
    want, _ = jmoe.moe_apply(jp, jx, cfg, jnp.float32)
    got, _ = tmoe.moe_apply(tp, tx, tcfg, torch.float32)
    want_zero = np.abs(np.asarray(want[0])).sum(-1) < 1e-9
    got_zero = got[0].abs().sum(-1).numpy() < 1e-9
    assert want_zero.sum() >= 8
    np.testing.assert_array_equal(got_zero, want_zero)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    # the kept routes are the first two per expert in token order (stable sort)
    r = tmoe.route(tp, tx.reshape(1, 16, 8), tcfg, 2)
    kept = torch.zeros(16, dtype=torch.bool)
    kept[r.order[0]] = r.dest[0] < 2 * 2
    for e in range(2):
        toks = (r.idx[0, :, 0] == e).nonzero()[:, 0]
        assert kept[toks].tolist() == [True] * min(2, len(toks)) + [False] * (len(toks) - 2)


@pytest.mark.parametrize("top_k,tied", [(1, (2, 5)), (2, (1, 4, 6))])
def test_top_k_ties_take_the_lower_expert_index(top_k, tied):
    # router columns that are equal and the largest for every token: the
    # probabilities tie exactly, and lax.top_k keeps the lower indices
    cfg = jmoe.MoEConfig(n_experts=8, top_k=top_k, d_model=16, d_ff=32, groups=4)
    tcfg = tmoe.MoEConfig(**vars(cfg))
    jp = jmoe.moe_init(jax.random.PRNGKey(1), cfg, jnp.float32)
    w = np.zeros((16, 8), np.float32)
    w[:, list(tied)] = 1.0
    w[:, 0] = 0.5
    jp = {**jp, "router": {"w": jnp.asarray(w)}}
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = np.abs(np.random.default_rng(2).normal(size=(2, 6, 16))).astype(np.float32)
    want_idx = _ref_top_k(jp, jnp.asarray(x), cfg)
    assert (want_idx == np.array(tied[:top_k])).all()
    np.testing.assert_array_equal(_port_top_k(tp, _t(x), tcfg), want_idx)
    want, want_aux = jmoe.moe_apply(jp, jnp.asarray(x), cfg, jnp.float32)
    got, aux = tmoe.moe_apply(tp, _t(x), tcfg, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(float(aux), float(want_aux), **F32)


@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
def test_moe_gradients_through_the_dispatch_match_the_reference(capacity_factor):
    cfg = jmoe.MoEConfig(n_experts=8, top_k=2, d_model=16, d_ff=32, groups=4,
                         capacity_factor=capacity_factor)
    tcfg = tmoe.MoEConfig(**vars(cfg))
    jp, tp, jx, tx = _moe_case(cfg, "float32", seed=3)
    wout = np.random.default_rng(9).normal(size=tx.shape).astype(np.float32)

    def jloss(p, x):
        out, aux = jmoe.moe_apply(p, x, cfg, jnp.float32)
        return (out * wout).sum() + aux

    grad = jax.jit(jax.grad(jloss, argnums=(0, 1)))
    jg, jgx = grad(jp, jx)
    tp = tree.tree_map(lambda t: t.requires_grad_(True), tp)
    tx = tx.requires_grad_(True)
    out, aux = tmoe.moe_apply(tp, tx, tcfg, torch.float32)
    ((out * _t(wout)).sum() + aux).backward()
    for (path, t), want in zip(tree.flatten_with_path(tp), jax.tree.leaves(jg)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5,
                                   err_msg="/".join(map(str, path)))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **F32)
    assert float(tp["router"]["w"].grad.abs().max()) > 0     # the gates and aux reach it


# ---------------------------------------------------------------- MLA


MLA = dict(d_model=32, n_heads=4, q_lora=16, kv_lora=8, d_nope=8, d_rope=4, d_v=8)


def _mla_case(dtype, seed=4, shape=(2, 12, 32)):
    jcfg, tcfg = jmla.MLAConfig(**MLA), tmla.MLAConfig(**MLA)
    jp = jmla.mla_init(jax.random.PRNGKey(seed), jcfg, jnp.dtype(dtype))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    return jcfg, tcfg, jp, tp, jx, params_from_jax(np.asarray(jx), "cpu")


def test_mla_init_tree_matches_the_reference():
    jcfg, tcfg = jmla.MLAConfig(**MLA), tmla.MLAConfig(**MLA)
    want = jax.eval_shape(functools.partial(jmla.mla_init, cfg=jcfg, param_dtype=jnp.bfloat16),
                          jax.random.PRNGKey(0))
    got = tmla.mla_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16, "cpu")
    wf = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [tuple(k.key for k in p) for p, _ in wf] == [p for p, _ in tree.flatten_with_path(got)]
    assert [tuple(a.shape) for _, a in wf] == [tuple(t.shape) for t in tree.leaves(got)]
    assert all(t.dtype == torch.bfloat16 for t in tree.leaves(got))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_and_absorbed_decode_match_the_reference(dtype):
    jcfg, tcfg, jp, tp, jx, tx = _mla_case(dtype)
    cd, tcd = jnp.dtype(dtype), getattr(torch, dtype)
    s0, max_len = 8, 16
    # training / prefill without a cache
    apply = jax.jit(functools.partial(jmla.mla_apply, cfg=jcfg, compute_dtype=cd))
    want = apply(jp, jx)
    got = tmla.mla_apply(tp, tx, tcfg, tcd)
    _close(got, np.asarray(want.astype(jnp.float32)), dtype)
    # prefill into a cache: the latent written in place at offset 0
    jcache = jmla.mla_make_cache(2, max_len, jcfg, cd)
    jpre, jcache = jmla.mla_apply(jp, jx[:, :s0], jcfg, cd, cache=jcache)
    cache = tmla.mla_make_cache(2, max_len, tcfg, tcd, "cpu")
    held = dict(cache)
    with torch.inference_mode():
        pre, cache = tmla.mla_apply(tp, tx[:, :s0], tcfg, tcd, cache=cache)
    assert all(cache[k] is held[k] for k in held)
    _close(pre, np.asarray(jpre.astype(jnp.float32)), dtype)
    for k in ("ckv", "krope"):
        assert cache[k].dtype == tcd and cache[k].shape == jcache[k].shape
        _close(cache[k], np.asarray(jcache[k].astype(jnp.float32)), dtype)
        assert not cache[k][:, s0:].any()
    # absorbed decode, one token at a time at cache_index 8, 9, 10, 11
    step = jax.jit(lambda p, x, pos, c: jmla.mla_apply(
        p, x, jcfg, cd, positions=jnp.full((2, 1), pos), cache=c, cache_index=pos))
    for pos in range(s0, tx.shape[1]):
        jdec, jcache = step(jp, jx[:, pos:pos + 1], pos, jcache)
        with torch.inference_mode():
            dec, cache = tmla.mla_apply(tp, tx[:, pos:pos + 1], tcfg, tcd,
                                        positions=torch.full((2, 1), pos), cache=cache,
                                        cache_index=pos)
        _close(dec, np.asarray(jdec.astype(jnp.float32)), dtype)
        for k in ("ckv", "krope"):
            _close(cache[k], np.asarray(jcache[k].astype(jnp.float32)), dtype)
    assert all(cache[k] is held[k] for k in held)
    # the absorbed form computes the materialised one's function (f32)
    if dtype == "float32":
        np.testing.assert_allclose(dec[:, 0].numpy(), got[:, -1].numpy(), rtol=2e-3, atol=1e-4)


def test_mla_gradients_match_the_reference():
    jcfg, tcfg, jp, tp, jx, tx = _mla_case("float32", seed=6, shape=(2, 10, 32))
    wout = np.random.default_rng(1).normal(size=tx.shape).astype(np.float32)
    jg = jax.grad(lambda p: (jmla.mla_apply(p, jx, jcfg, jnp.float32) * wout).sum())(jp)
    tp = tree.tree_map(lambda t: t.requires_grad_(True), tp)
    (tmla.mla_apply(tp, tx, tcfg, torch.float32) * _t(wout)).sum().backward()
    for (path, t), want in zip(tree.flatten_with_path(tp), jax.tree.leaves(jg)):
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float((t.grad - _t(np.asarray(want))).abs().max()) <= 1e-4 * scale, path

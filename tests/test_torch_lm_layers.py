"""The port's LM layers (``repro_torch.nn.layers``) held against the JAX
package's ``repro.nn.layers`` on the same numpy-seeded inputs and
JAX-initialised parameters carried across by ``params_from_jax``.

Tolerances: f32 operations that match one for one (dense, rmsnorm, the
MLPs, rope, the attention helpers) 1e-5; the flash forward on the
reference test's grid of blocks rtol/atol 3e-4 and its backward's dq, dk,
dv 2e-3 (``tests/test_layers.py:39-63``: the block loop sums the scores in
another order than the JAX scan); decode against full attention 2e-3
(``tests/test_layers.py:67``); a bf16 attention 3e-2 (one bf16 rounding
of each stored value: ROADMAP's bf16 tolerance).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import layers as jl
from repro_torch.convert import params_from_jax
from repro_torch.nn import layers as tl

B, S, H, HKV, DH = 2, 130, 8, 4, 16
GRID = [(32, 48), (64, 64), (130, 130), (16, 128)]


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _qkv(dv=DH, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, DH)).astype(np.float32)
    k = rng.normal(size=(B, S, HKV, DH)).astype(np.float32)
    v = rng.normal(size=(B, S, HKV, dv)).astype(np.float32)
    return q, k, v


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got.detach().float()), _np(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------- basics


def test_dense_rmsnorm_and_rope_match_the_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    w = rng.normal(size=(32, 24)).astype(np.float32)
    _close(tl.dense({"w": _t(w)}, _t(x), torch.float32),
           jl.dense({"w": jnp.asarray(w)}, jnp.asarray(x), jnp.float32), 1e-5)
    g = rng.normal(size=(32,)).astype(np.float32)
    _close(tl.rmsnorm({"g": _t(g)}, _t(x)), jl.rmsnorm({"g": jnp.asarray(g)}, jnp.asarray(x)),
           1e-5)
    xr = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    pos = np.arange(3, 12)[None, :].repeat(2, 0)
    _close(tl.rope(_t(xr), _t(pos), 1e4), jl.rope(jnp.asarray(xr), jnp.asarray(pos), 1e4), 1e-5)
    # rope keeps the norm and depends on relative positions only
    out = tl.rope(_t(xr), _t(pos))
    torch.testing.assert_close(out.norm(dim=-1), _t(xr).norm(dim=-1), rtol=1e-5, atol=1e-5)


def test_init_layouts_match_the_reference():
    gen = torch.Generator().manual_seed(0)
    cfg = tl.AttnConfig(d_model=32, n_heads=H, n_kv_heads=HKV, d_head=DH, qk_norm=True)
    got = tl.attention_init(gen, cfg, torch.float32, "cpu")
    want = jax.eval_shape(lambda: jl.attention_init(jax.random.PRNGKey(0),
                                                    jl.AttnConfig(**vars(cfg)), jnp.float32))
    assert jax.tree.map(lambda a: a.shape, want) == {
        k: {kk: tuple(vv.shape) for kk, vv in v.items()} for k, v in got.items()}
    for kind in ("swiglu", "gelu", "relu"):
        p = tl.mlp_init(gen, 32, 48, torch.bfloat16, kind, "cpu")
        jp = jax.eval_shape(functools.partial(jl.mlp_init, jax.random.PRNGKey(0), 32, 48,
                                              jnp.bfloat16, kind))
        assert set(p) == set(jp)
        assert all(p[k]["w"].dtype == torch.bfloat16 and tuple(p[k]["w"].shape) == jp[k]["w"].shape
                   for k in p)
    # the scale (1/d_in)**0.5 of a standard normal draw
    w = tl.dense_init(gen, 256, 512, torch.float32, device="cpu")["w"]
    assert abs(float(w.std()) - 256 ** -0.5) < 2e-3


@pytest.mark.parametrize("kind", ["swiglu", "gelu", "relu"])
def test_mlp_matches_the_reference(kind):
    jp = jl.mlp_init(jax.random.PRNGKey(2), 32, 48, jnp.float32, kind)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(2).normal(size=(2, 7, 32)).astype(np.float32)
    _close(tl.mlp(tp, _t(x), torch.float32, kind),
           jl.mlp(jp, jnp.asarray(x), jnp.float32, kind), 1e-5)


# ---------------------------------------------------------------- flash


@pytest.mark.parametrize("bq,bk", GRID)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward(bq, bk, causal):
    q, k, v = _qkv()
    fn = jax.jit(functools.partial(jl.flash_attention, causal=causal, block_q=bq, block_k=bk))
    want = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = tl.flash_attention(_t(q), _t(k), _t(v), causal=causal, block_q=bq, block_k=bk)
    assert got.shape == (B, S, H, DH)
    _close(got, want, 3e-4)


def test_flash_dv_not_equal_dqk_and_q_offset():
    q, k, v = _qkv(dv=24)
    fn = jax.jit(functools.partial(jl.flash_attention, causal=True, block_q=32, block_k=32))
    want = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = tl.flash_attention(_t(q), _t(k), _t(v), causal=True, block_q=32, block_k=32)
    _close(got, want, 3e-4)
    # a query block at an absolute offset over a shorter valid key length
    fn = jax.jit(functools.partial(jl.flash_attention, causal=True, q_offset=90, block_q=16,
                                   block_k=48))
    want = fn(jnp.asarray(q[:, :20]), jnp.asarray(k), jnp.asarray(v), kv_len=jnp.int32(100))
    got = tl.flash_attention(_t(q[:, :20]), _t(k), _t(v), causal=True, q_offset=90,
                             block_q=16, block_k=48, kv_len=100)
    _close(got, want, 3e-4)


def test_flash_backward_matches_the_reference_vjp():
    q, k, v = _qkv()
    rng = np.random.default_rng(3)
    w = rng.normal(size=(B, S, H, DH)).astype(np.float32)

    def lf(q, k, v):
        return (jl.flash_attention(q, k, v, causal=True, block_q=32, block_k=48) * w).sum()

    grad = jax.jit(jax.grad(lf, argnums=(0, 1, 2)))
    want = grad(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = tl.flash_attention(tq, tk, tv, causal=True, block_q=32, block_k=48)
    # the recompute backward, not autograd through the block loop
    assert type(out.grad_fn).__name__ == "_FlashFnBackward"
    (out * _t(w)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        _close(got, ref, 2e-3)


# ---------------------------------------------------------------- attention


@pytest.fixture(scope="module")
def attn_case():
    cfg = jl.AttnConfig(d_model=32, n_heads=H, n_kv_heads=HKV, d_head=DH, qk_norm=True)
    jp = jl.attention_init(jax.random.PRNGKey(3), cfg, jnp.float32)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, S, 32)).astype(np.float32)
    xt = rng.normal(size=(B, 1, 32)).astype(np.float32)

    def run(p, x, xt):
        cache = jl.make_cache(B, S + 8, HKV, DH, jnp.float32)
        _, cache = jl.attention(p, x, cfg, jnp.float32, cache=cache)
        return jl.attention(p, xt, cfg, jnp.float32, cache=cache, cache_index=S,
                            positions=jnp.full((B, 1), S))

    run = jax.jit(run)
    out_dec, cache = run(jp, jnp.asarray(x), jnp.asarray(xt))
    return cfg, jp, x, xt, out_dec, cache


def test_attention_decode_matches_the_reference_and_full(attn_case):
    cfg, jp, x, xt, want_dec, want_cache = attn_case
    tcfg = tl.AttnConfig(**vars(cfg))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    cache = tl.make_cache(B, S + 8, HKV, DH, torch.float32, "cpu")
    with torch.inference_mode():
        _, cache = tl.attention(tp, _t(x), tcfg, torch.float32, cache=cache)
        out_dec, cache = tl.attention(tp, _t(xt), tcfg, torch.float32, cache=cache,
                                      cache_index=S, positions=torch.full((B, 1), S))
        full = tl.attention(tp, torch.cat([_t(x), _t(xt)], 1), tcfg, torch.float32)
    _close(out_dec, want_dec, 1e-5)
    _close(cache["k"], want_cache["k"], 1e-5)
    _close(cache["v"], want_cache["v"], 1e-5)
    torch.testing.assert_close(out_dec[:, 0], full[:, -1], rtol=2e-3, atol=2e-3)


def test_cross_attention_helpers_match_the_reference(attn_case):
    cfg, jp, x, xt, _, _ = attn_case
    tcfg = tl.AttnConfig(**vars(cfg))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    mem = np.random.default_rng(5).normal(size=(B, 11, 32)).astype(np.float32)

    def run(p, mem, xt, xs):
        k, v = jl.cross_kv(p, mem, cfg, jnp.float32)
        return (k, v, jl.attention_with_kv(p, xt, k, v, cfg, jnp.float32),
                jl.attention(p, xs, cfg, jnp.float32, kv_x=mem))

    run = jax.jit(run)
    jk, jv, want_kv, want_x = run(jp, jnp.asarray(mem), jnp.asarray(xt), jnp.asarray(x[:, :9]))
    tk, tv = tl.cross_kv(tp, _t(mem), tcfg, torch.float32)
    _close(tk, jk, 1e-5)
    _close(tv, jv, 1e-5)
    _close(tl.attention_with_kv(tp, _t(xt), tk, tv, tcfg, torch.float32), want_kv, 1e-5)
    # cross-attention through attention(kv_x=): non-causal, no rope on the keys
    _close(tl.attention(tp, _t(x[:, :9]), tcfg, torch.float32, kv_x=_t(mem)), want_x, 1e-5)


def test_bf16_attention_matches_the_reference():
    cfg = jl.AttnConfig(d_model=64, n_heads=4, n_kv_heads=2, d_head=16)
    jp = jl.attention_init(jax.random.PRNGKey(6), cfg, jnp.bfloat16)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(6).normal(size=(2, 40, 64)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = _t(x).to(torch.bfloat16)

    def run(p, x):
        p32 = jax.tree.map(lambda a: a.astype(jnp.float32), p)
        return (jl.attention(p, x, cfg, jnp.bfloat16),
                jl.attention(p32, x.astype(jnp.float32), cfg, jnp.float32))

    run = jax.jit(run)
    want, want32 = run(jp, jx)
    got = tl.attention(tp, tx, tl.AttnConfig(**vars(cfg)), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _close(got, want, 3e-2)
    # the scores stay f32: the same inputs in f32 land within bf16's rounding
    _close(got, want32, 3e-2)

"""The port's Mamba2 block (``repro_torch.nn.ssm``) held against the JAX
package's ``repro.nn.ssm`` on the CPU: the reference's ``ssm_init``
weights carried across by ``params_from_jax``, numpy-seeded inputs.

Tolerances: f32 rtol 1e-4 / atol 1e-5; bf16 within 3e-2 of the largest
magnitude (the port rounds each bf16 step where XLA's CPU backend may keep
f32 between fused elementwise steps).  The block at
``SSMConfig(d_model=32, d_state=8, headdim=8, chunk=16)``, the reference's
own test size.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import ssm as jssm
from repro_torch import tree
from repro_torch.convert import params_from_jax
from repro_torch.nn import ssm as tssm

JCFG = jssm.SSMConfig(d_model=32, d_state=8, headdim=8, chunk=16)
TCFG = tssm.SSMConfig(d_model=32, d_state=8, headdim=8, chunk=16)
RTOL, ATOL, BF16_TOL = 1e-4, 1e-5, 3e-2
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# S a multiple of the chunk, not a multiple (padded), shorter than the chunk
LENGTHS = (32, 40, 10)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, kind):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if kind == "f32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(got - want).max() <= BF16_TOL * scale, (np.abs(got - want).max(), scale)


# the compiled reference's init, one compile per dtype
_INIT = {kind: jax.jit(functools.partial(jssm.ssm_init, cfg=JCFG, param_dtype=jdt))
         for kind, (jdt, _) in DTYPES.items()}


def _params(kind, seed=0):
    jp = _INIT[kind](jax.random.PRNGKey(seed))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _input(s, seed=1, scale=0.5, b=2):
    return (np.random.default_rng(seed).normal(size=(b, s, JCFG.d_model)) * scale).astype(
        np.float32)


def test_config_and_init_tree_match_the_reference():
    assert (TCFG.d_inner, TCFG.n_heads, TCFG.d_xbc) == (JCFG.d_inner, JCFG.n_heads, JCFG.d_xbc)
    for kind, (jdt, tdt) in DTYPES.items():
        want = _INIT[kind](jax.random.PRNGKey(0))      # as the archs' tests initialise it
        got = tssm.ssm_init(torch.Generator().manual_seed(0), TCFG, tdt, "cpu")
        wf = jax.tree_util.tree_flatten_with_path(want)[0]
        gf = tree.flatten_with_path(got)
        assert [tuple(k.key for k in p) for p, _ in wf] == [p for p, _ in gf]
        assert [(a.shape, str(a.dtype)) for _, a in wf] \
            == [(tuple(t.shape), str(t.dtype).removeprefix("torch.")) for _, t in gf]
        for name in ("A_log", "D", "dt_bias"):             # f32 whatever the param dtype
            assert got[name].dtype == torch.float32
        for name in ("A_log", "D", "dt_bias", "conv_b", "norm_g"):   # deterministic leaves
            np.testing.assert_array_equal(_np(got[name]), _np(want[name]))


@pytest.mark.parametrize("heads", [8, 16, 32, 64])
def test_a_log_equals_the_compiled_reference(heads):
    # the reduced test block (8), the reduced archs (16), mamba2-370m (32),
    # zamba2-1.2b (64)
    cfg = jssm.SSMConfig(d_model=heads * 4, d_state=8, headdim=8)
    # the compiled init with its other leaves cut away: the same program for
    # A_log, a fraction of the compile
    init = jax.jit(lambda k: jssm.ssm_init(k, cfg, jnp.float32)["A_log"])
    want = np.asarray(init(jax.random.PRNGKey(0)))
    got = tssm._a_log(heads).numpy()
    if heads <= 32:
        np.testing.assert_array_equal(got, want)
    else:
        # at 48 heads and more XLA no longer folds the constant and takes its
        # own run-time logarithm, within one f32 ulp of the rounded f64 one
        ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
        assert ulps.max() <= 1
    np.testing.assert_allclose(got, np.log(np.linspace(1.0, 16.0, heads)), rtol=1e-6)


def test_softplus_is_logaddexp_around_20():
    # torch.nn.functional.softplus returns x itself above its threshold of
    # 20; the reference's is logaddexp(x, 0) everywhere
    x = np.concatenate([np.linspace(-30, 30, 601), np.linspace(19.0, 21.0, 401),
                        np.float32([20.0, np.nextafter(20.0, 21.0), 88.0, -80.0])]
                       ).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = tssm._softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    near = np.abs(x - 20.0) <= 1.0
    np.testing.assert_array_equal(got[near], want[near])


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_causal_conv_and_gated_norm_match_the_reference(kind):
    jdt, tdt = DTYPES[kind]
    jp, tp = _params(kind)
    rng = np.random.default_rng(3)
    xbc = rng.normal(size=(2, 20, JCFG.d_xbc)).astype(np.float32)
    conv = jax.jit(jssm._causal_conv)
    want = conv(jnp.asarray(xbc).astype(jdt), jp["conv_w"].astype(jdt),
                jp["conv_b"].astype(jdt))
    got = tssm._causal_conv(torch.from_numpy(xbc).to(tdt), tp["conv_w"].to(tdt),
                            tp["conv_b"].to(tdt))
    assert got.dtype == tdt
    _close(got, want, kind)
    y, z = (rng.normal(size=(2, 20, JCFG.d_inner)).astype(np.float32) for _ in range(2))
    g = (1.0 + 0.1 * rng.normal(size=JCFG.d_inner)).astype(np.float32)
    norm = jax.jit(jssm._gated_norm)
    want = norm(jnp.asarray(y).astype(jdt), jnp.asarray(z).astype(jdt), jnp.asarray(g).astype(jdt))
    got = tssm._gated_norm(torch.from_numpy(y).to(tdt), torch.from_numpy(z).to(tdt),
                           torch.from_numpy(g).to(tdt))
    assert got.dtype == tdt
    _close(got, want, kind)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("s", LENGTHS)
def test_ssm_apply_and_its_state_match_the_reference(kind, s):
    jdt, tdt = DTYPES[kind]
    jp, tp = _params(kind)
    u = _input(s)
    apply = jax.jit(lambda p, x: jssm.ssm_apply(p, x, JCFG, jdt, return_state=True))
    want = apply(jp, jnp.asarray(u).astype(jdt))
    plain = tssm.ssm_apply(tp, torch.from_numpy(u).to(tdt), TCFG, tdt)
    got, st = tssm.ssm_apply(tp, torch.from_numpy(u).to(tdt), TCFG, tdt, return_state=True)
    assert got.dtype == tdt and got.shape == (2, s, JCFG.d_model)
    assert torch.equal(plain, got)
    _close(got, want[0], kind)
    assert st["ssm"].dtype == torch.float32 and st["conv"].dtype == tdt
    assert tuple(st["conv"].shape) == (2, JCFG.d_conv - 1, JCFG.d_xbc)
    _close(st["ssm"], want[1]["ssm"], kind)
    _close(st["conv"], want[1]["conv"], kind)


def test_a_prompt_shorter_than_the_conv_window_is_refused_at_prefill():
    _, tp = _params("f32")
    u = torch.from_numpy(_input(JCFG.d_conv - 2))
    assert tssm.ssm_apply(tp, u, TCFG, torch.float32).shape == u.shape   # no state: fine
    with pytest.raises(ValueError, match="d_conv - 1 = 3"):
        tssm.ssm_apply(tp, u, TCFG, torch.float32, return_state=True)
    tssm.ssm_apply(tp, torch.from_numpy(_input(JCFG.d_conv - 1)), TCFG, torch.float32,
                   return_state=True)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_make_cache_and_decode_step_by_step_match_the_reference(kind):
    jdt, tdt = DTYPES[kind]
    jp, tp = _params(kind, seed=2)
    s = 24
    u = _input(s, seed=4)
    jcache = jssm.ssm_make_cache(2, JCFG, jdt)
    cache = tssm.ssm_make_cache(2, TCFG, tdt, "cpu")
    for k in ("ssm", "conv"):
        assert tuple(cache[k].shape) == jcache[k].shape
        assert str(cache[k].dtype).removeprefix("torch.") == str(jcache[k].dtype)
        assert not cache[k].any()
    held = dict(cache)
    step = jax.jit(lambda p, x, c: jssm.ssm_decode(p, x, JCFG, jdt, c))
    for t in range(s):
        want, jcache = step(jp, jnp.asarray(u[:, t:t + 1]).astype(jdt), jcache)
        got, cache = tssm.ssm_decode(tp, torch.from_numpy(u[:, t:t + 1]).to(tdt), TCFG, tdt,
                                     cache)
        assert got.shape == (2, 1, JCFG.d_model) and got.dtype == tdt
        _close(got, want, kind)
    for k in ("ssm", "conv"):
        assert cache[k] is held[k]                          # updated in place
        _close(cache[k], jcache[k], kind)


def test_prefill_state_equals_the_state_decoded_token_by_token():
    # the reference's own check and tolerances (tests/test_layers.py), on
    # the port alone, at a length the chunk does not divide
    _, tp = _params("f32", seed=2)
    u = torch.from_numpy(_input(40, seed=5))
    _, st = tssm.ssm_apply(tp, u, TCFG, torch.float32, return_state=True)
    cache = tssm.ssm_make_cache(2, TCFG, torch.float32, "cpu")
    outs = []
    for t in range(40):
        o, cache = tssm.ssm_decode(tp, u[:, t:t + 1], TCFG, torch.float32, cache)
        outs.append(o)
    np.testing.assert_allclose(_np(st["ssm"]), _np(cache["ssm"]), rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(_np(st["conv"]), _np(cache["conv"]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(torch.cat(outs, 1)),
                               _np(tssm.ssm_apply(tp, u, TCFG, torch.float32)),
                               rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("s", [40, 10])
def test_gradients_match_jax_grad(s):
    jp, tp = _params("f32", seed=6)
    u = _input(s, seed=7)
    w = np.random.default_rng(8).normal(size=(2, s, JCFG.d_model)).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jssm.ssm_apply(p, x, JCFG, jnp.float32) * w)

    grad = jax.jit(jax.grad(jloss, argnums=(0, 1)))
    gp_want, gu_want = grad(jp, jnp.asarray(u))
    tp = tree.tree_map(lambda t: t.requires_grad_(True), tp)
    tu = torch.from_numpy(u).requires_grad_(True)
    (tssm.ssm_apply(tp, tu, TCFG, torch.float32) * torch.from_numpy(w)).sum().backward()
    for (path, leaf), want in zip(tree.flatten_with_path(tp), jax.tree.leaves(gp_want)):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert np.abs(leaf.grad.numpy() - want).max() <= RTOL * scale, path
    np.testing.assert_allclose(tu.grad.numpy(), np.asarray(gu_want), rtol=RTOL,
                               atol=RTOL * np.abs(np.asarray(gu_want)).max())


def test_masked_decay_keeps_the_gradient_finite_where_exp_overflows():
    # large inputs drive dt·|A| past 88 within a chunk: exp(cs_i − cs_j)
    # overflows in f32 where j > i (masked out).  The reference's
    # where(mask, exp(.), 0) passes 0·inf = NaN back to the exponent; the
    # port masks the exponent, so its forward equals the reference's and
    # its gradient stays finite
    jp, tp = _params("f32", seed=9)
    u = _input(32, seed=10, scale=40.0)

    def japply(p):
        return jssm.ssm_apply(p, jnp.asarray(u), JCFG, jnp.float32)

    # the output and the gradient of its sum from one compile
    both = jax.jit(lambda p: (japply(p), jax.grad(lambda q: jnp.sum(japply(q)))(p)))
    want, jgrad = both(jp)
    assert not all(np.isfinite(np.asarray(g)).all() for g in jax.tree.leaves(jgrad))
    tp = tree.tree_map(lambda t: t.requires_grad_(True), tp)
    out = tssm.ssm_apply(tp, torch.from_numpy(u), TCFG, torch.float32)
    np.testing.assert_allclose(_np(out), _np(want), rtol=RTOL,
                               atol=RTOL * np.abs(_np(want)).max())
    out.sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in tree.leaves(tp))

"""The multi-hot QR embedding bag (K3 ``qr_embedding_bag``): the port's
``ops.qr_bag_lookup`` held against the reference's ``qr_bag_lookup`` with
its Pallas kernel in interpret mode, over the reference's sweep
(``tests/test_kernels.py:35-45``) plus fractional bf16 weights, the
f32-accumulation audit at L=16, D=128 (``tests/test_kernels.py:84-122``)
with a control that a bf16 running sum fails it, and the int8 bag's mask
semantics (``tests/test_serve_quant.py:169-181``).  On the CPU the port's
wrapper takes the plain version; the CUDA kernel is held against it in
``test_torch_gpu.py``.

Tolerances: f32 outputs 1e-5 (both sides sum in f32, in another order);
bf16 outputs 3e-2 (``tests/test_kernels.py:12``); the audit rtol 5e-3
against an f32 oracle, a bound a bf16 running sum breaks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.serve.quantize import quantize_table as jax_quantize_table
from repro_torch.convert import params_from_jax
from repro_torch.kernels import embedding_bag, ops, ref

TOL = {"f32": 1e-5, "bf16": 3e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _t(x):
    return params_from_jax(np.asarray(x), device="cpu")


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else jnp.asarray(x, jnp.float32))


def _pair(rng, m, q, d, mode, positive=False):
    wr, wq = rng.normal(size=(m, d)), rng.normal(size=(q, d))
    if positive:           # no cancellation: a bf16 running sum's error compounds
        wr, wq = np.abs(wr) + 0.5, np.abs(wq) + 0.5
    jwr = jnp.asarray(wr.astype(np.float32), JDT[mode])
    jwq = jnp.asarray(wq.astype(np.float32), JDT[mode])
    return (jwr, jwq), (_t(jwr), _t(jwq))


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("b,l,m,q,d", [(4, 3, 11, 4, 16), (8, 16, 64, 8, 128),
                                       (3, 7, 29, 5, 64)])
@pytest.mark.parametrize("op", ["mult", "add"])
@pytest.mark.parametrize("weights", ["binary", "fractional"])
def test_qr_bag_matches_reference_kernel(mode, b, l, m, q, d, op, weights):
    rng = np.random.default_rng(b * l + d)
    (jwr, jwq), (twr, twq) = _pair(rng, m, q, d, mode)
    idx = rng.integers(0, m * q, size=(b, l)).astype(np.int32)
    if weights == "binary":
        mask = (rng.random((b, l)) > 0.3).astype(np.float32)
    else:
        mask = rng.choice([0.0, 0.3, 0.7, 1.0, 1.9], size=(b, l)).astype(np.float32)
    mask[-1] = 0.0                                          # an empty bag
    jmask = jnp.asarray(mask, JDT[mode])                    # the reference's sweep mask dtype
    want = jops.qr_bag_lookup(jnp.asarray(idx), jmask, jwr, jwq, op=op, interpret=True)
    tmask = _t(jmask)
    got = ops.qr_bag_lookup(torch.from_numpy(idx), tmask, twr, twq, op=op)
    assert tuple(got.shape) == want.shape == (b, d)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[mode], atol=TOL[mode])
    np.testing.assert_array_equal(_np(got)[-1], 0.0)
    # an f32 mask rounds to the table dtype first, as the reference's wrapper does
    got_f32_mask = ops.qr_bag_lookup(torch.from_numpy(idx), torch.from_numpy(mask), twr, twq,
                                     op=op)
    torch.testing.assert_close(got_f32_mask, got, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("op", ["mult", "add"])
def test_raw_id_route_matches_reference_kernel(mode, op):
    """The route ``ops.qr_bag_lookup`` takes for a dense pair: the raw ids
    and the mask into ``qr_embedding_bag_raw``, which splits the ids
    itself (no ``_split`` before it), against the reference's
    ``qr_bag_lookup`` in interpret mode; edge ids 0, m-1, m and size-1,
    fractional weights and an empty bag."""
    rng = np.random.default_rng(21 + len(mode))
    m, q, d, b, length = 29, 5, 64, 6, 7
    size = m * q - 2
    (jwr, jwq), (twr, twq) = _pair(rng, m, q, d, mode)
    idx = rng.integers(0, size, size=(b, length)).astype(np.int32)
    idx[:4, 0] = (0, m - 1, m, size - 1)
    mask = rng.choice([0.0, 0.3, 1.0, 1.9], size=(b, length)).astype(np.float32)
    mask[:4, 0] = 1.0
    mask[-1] = 0.0
    want = jops.qr_bag_lookup(jnp.asarray(idx), jnp.asarray(mask, JDT[mode]), jwr, jwq, op=op,
                              interpret=True)
    ti, tm = torch.from_numpy(idx), torch.from_numpy(mask)
    got = ref.qr_embedding_bag_raw(ti, tm, twr, twq, op=op)
    assert got.dtype == twr.dtype and tuple(got.shape) == want.shape == (b, d)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[mode], atol=TOL[mode])
    np.testing.assert_array_equal(_np(got)[-1], 0.0)
    torch.testing.assert_close(ops.qr_bag_lookup(ti, tm, twr, twq, op=op), got, rtol=0, atol=0)
    torch.testing.assert_close(embedding_bag.qr_embedding_bag_raw(ti, tm, twr, twq, op=op), got,
                               rtol=0, atol=0)


def test_bf16_weights_round_before_they_multiply():
    """Three slots of weight 0.3 on rows of 1.0: the weight rounds to bf16
    (0.30078125) first, so the bag is 0.90234375 — with the f32 weight it
    would round to 0.8984375.  The reference's kernel agrees."""
    ones = jnp.ones((4, 8), jnp.bfloat16)
    idx = np.zeros((1, 3), np.int32)
    mask = np.full((1, 3), 0.3, np.float32)
    got = ops.qr_bag_lookup(torch.from_numpy(idx), torch.from_numpy(mask), _t(ones), _t(ones))
    np.testing.assert_array_equal(_np(got), 0.90234375)
    want = jops.qr_bag_lookup(jnp.asarray(idx), jnp.asarray(mask), ones, ones, interpret=True)
    np.testing.assert_array_equal(_np(want), 0.90234375)
    f32_weight = torch.tensor(0.9, dtype=torch.float32).to(torch.bfloat16)
    assert float(f32_weight) == 0.8984375


def test_empty_bags_pool_to_zero():
    rng = np.random.default_rng(0)
    _, (twr, twq) = _pair(rng, 11, 4, 16, "bf16")
    idx = torch.zeros((5, 0), dtype=torch.int32)
    got = embedding_bag.qr_embedding_bag(idx, idx, torch.zeros((5, 0)), twr, twq)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (5, 16)
    assert (got == 0).all()
    with pytest.raises(ValueError, match="mult or add"):
        embedding_bag.qr_embedding_bag(idx, idx, torch.zeros((5, 0)), twr, twq, op="concat")


# ------------------------------------------------- accumulation audit

AUDIT_B, AUDIT_L, AUDIT_D = 8, 16, 128


def _audit_inputs(seed):
    rng = np.random.default_rng(seed)
    m, q = 64, 8
    (jwr, jwq), (twr, twq) = _pair(rng, m, q, AUDIT_D, "bf16", positive=True)
    idx = rng.integers(0, m * q, size=(AUDIT_B, AUDIT_L)).astype(np.int32)
    return m, (jwr, jwq), (twr, twq), idx


def _f32_oracle(m, jwr, jwq, idx, op):
    a = np.asarray(jwr, np.float32)[idx % m]
    b = np.asarray(jwq, np.float32)[idx // m]
    rows = a * b if op == "mult" else a + b
    return rows.sum(axis=1), rows


@pytest.mark.parametrize("op", ["mult", "add"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_bag_accumulates_f32_at_L16_D128(op, use_kernel):
    m, (jwr, jwq), (twr, twq), idx = _audit_inputs(10)
    mask = torch.ones((AUDIT_B, AUDIT_L), dtype=torch.bfloat16)
    got = ops.qr_bag_lookup(torch.from_numpy(idx), mask, twr, twq, op=op,
                            use_kernel=use_kernel)
    assert got.dtype == torch.bfloat16
    want, _ = _f32_oracle(m, jwr, jwq, idx, op)
    np.testing.assert_allclose(_np(got), want, rtol=5e-3, atol=0)
    jax_got = jops.qr_bag_lookup(jnp.asarray(idx), jnp.ones((AUDIT_B, AUDIT_L), jnp.bfloat16),
                                 jwr, jwq, op=op, use_kernel=use_kernel, interpret=True)
    np.testing.assert_allclose(_np(got), _np(jax_got), rtol=3e-2, atol=0)


def test_bag_concat_accumulates_f32_at_L16_D128():
    m, (jwr, jwq), (twr, twq), idx = _audit_inputs(12)
    got = ops.qr_bag_lookup(torch.from_numpy(idx), torch.ones((AUDIT_B, AUDIT_L)), twr, twq,
                            op="concat")
    want = np.concatenate([np.asarray(jwr, np.float32)[idx % m],
                           np.asarray(jwq, np.float32)[idx // m]], axis=-1).sum(axis=1)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (AUDIT_B, 2 * AUDIT_D)
    np.testing.assert_allclose(_np(got), want, rtol=5e-3, atol=0)


@pytest.mark.parametrize("op", ["mult", "add"])
def test_audit_rejects_a_bf16_running_sum(op):
    """Control: the audit's bound is tight enough that a bf16 running sum
    (one rounding per add) fails it, so the passing audit means f32."""
    m, (jwr, jwq), _, idx = _audit_inputs(10)
    want, rows = _f32_oracle(m, jwr, jwq, idx, op)
    acc = torch.zeros((AUDIT_B, AUDIT_D), dtype=torch.bfloat16)
    for lane in range(AUDIT_L):
        acc = acc + torch.from_numpy(rows[:, lane]).to(torch.bfloat16)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(_np(acc), want, rtol=5e-3, atol=0)


# ------------------------------------------------- quantized bags


def test_qr_bag_lookup_quantized_mask_semantics():
    """Masked slots of a quantized bag contribute exactly nothing, and the
    quantized and mixed pairs pool as the reference does (f32 out)."""
    rng = np.random.default_rng(8)
    jqr = jax_quantize_table(jnp.asarray(rng.normal(size=(40, 16)).astype(np.float32)))
    jqq = jax_quantize_table(jnp.asarray(rng.normal(size=(5, 16)).astype(np.float32)))
    tqr, tqq = ({k: _t(v) for k, v in t.items()} for t in (jqr, jqq))
    idx = rng.integers(0, 200, size=(4, 6)).astype(np.int32)
    mask = np.tile(np.asarray([1, 1, 1, 0, 0, 0], np.float32), (4, 1))
    ti, tm = torch.from_numpy(idx), torch.from_numpy(mask)
    got = ops.qr_bag_lookup(ti, tm, tqr, tqq)
    assert got.dtype == torch.float32
    garbage = ti.clone()
    garbage[:, 3:] = 199                       # garbage in the masked tail
    torch.testing.assert_close(ops.qr_bag_lookup(garbage, tm, tqr, tqq), got, rtol=0, atol=0)
    torch.testing.assert_close(ops.qr_bag_lookup(ti[:, :3], tm[:, :3], tqr, tqq), got,
                               rtol=0, atol=1e-6)
    dense_quo = jnp.asarray(rng.normal(size=(5, 16)).astype(np.float32))
    for jt, tt, op in (((jqr, jqq), (tqr, tqq), "mult"), ((jqr, jqq), (tqr, tqq), "add"),
                       ((jqr, jqq), (tqr, tqq), "concat"),
                       ((jqr, dense_quo), (tqr, _t(dense_quo)), "mult")):
        want = jops.qr_bag_lookup(jnp.asarray(idx), jnp.asarray(mask), *jt, op=op)
        got = ops.qr_bag_lookup(ti, tm, *tt, op=op)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)


def test_plain_version_is_the_wrappers_cpu_route():
    rng = np.random.default_rng(3)
    _, (twr, twq) = _pair(rng, 29, 5, 64, "f32")
    idx = torch.from_numpy(rng.integers(0, 145, size=(3, 7)))
    mask = torch.from_numpy(rng.random((3, 7)).astype(np.float32))
    rem, quo = idx % 29, idx // 29
    for op in ("mult", "add"):
        torch.testing.assert_close(embedding_bag.qr_embedding_bag(rem, quo, mask, twr, twq, op=op),
                                   ref.qr_embedding_bag(rem, quo, mask, twr, twq, op=op),
                                   rtol=0, atol=0)

"""The one-hot QR lookup (K1 ``qr_gather``, K5 ``qr_gather_quant``): the
port's ``ops.qr_lookup`` held against the reference's ``qr_lookup`` with
its Pallas kernels in interpret mode, over the reference's own sweeps
(``tests/test_kernels.py:22-73,125-134``,
``tests/test_serve_quant.py:121-166``).  On the CPU the port's wrappers
take the plain versions; the CUDA kernels are held against those in
``test_torch_gpu.py``.

Tolerances: f32 and int8 outputs 1e-5 (both sides compute the same f32
products and sums); bf16 outputs 3e-2 (``tests/test_kernels.py:12``); the
bf16 single-rounding case rtol 5e-3 against an f32 oracle, as the
reference holds its kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.qr_gather import qr_gather_quant as jax_qr_gather_quant
from repro.serve.quantize import quantize_table as jax_quantize_table
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops, qr_gather, ref

TOL = {"f32": 1e-5, "int8": 1e-5, "bf16": 3e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _t(x):
    return params_from_jax(np.asarray(x), device="cpu")


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else jnp.asarray(x, jnp.float32))


def _dense_pair(rng, m, q, d, mode):
    wr = jnp.asarray(rng.normal(size=(m, d)).astype(np.float32), JDT[mode])
    wq = jnp.asarray(rng.normal(size=(q, d)).astype(np.float32), JDT[mode])
    return (wr, wq), (_t(wr), _t(wq))


def _int8_pair(rng, m, q, d):
    qr_ = jax_quantize_table(jnp.asarray(rng.normal(size=(m, d)).astype(np.float32)))
    qq_ = jax_quantize_table(jnp.asarray(rng.normal(size=(q, d)).astype(np.float32)))
    return (qr_, qq_), tuple({k: _t(v) for k, v in t.items()} for t in (qr_, qq_))


def _assert_dtype_like(got, want):
    assert str(got.dtype).split(".")[-1] == str(want.dtype)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("m,q,d,n", [(7, 3, 16, 5), (128, 8, 128, 64),
                                     (33, 5, 256, 17), (1000, 4, 32, 200)])
@pytest.mark.parametrize("op", ["mult", "add"])
def test_qr_gather_matches_reference_kernel(mode, m, q, d, n, op):
    rng = np.random.default_rng(m * q + d + n)
    (jwr, jwq), (twr, twq) = _dense_pair(rng, m, q, d, mode)
    idx = rng.integers(0, m * q, size=(n,)).astype(np.int32)
    want = jops.qr_lookup(jnp.asarray(idx), jwr, jwq, op=op, interpret=True)
    got = ops.qr_lookup(torch.from_numpy(idx), twr, twq, op=op)
    assert tuple(got.shape) == want.shape == (n, d)
    _assert_dtype_like(got, want)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[mode], atol=TOL[mode])
    # the kernel route and the plain route agree exactly on the CPU
    plain = ops.qr_lookup(torch.from_numpy(idx), twr, twq, op=op, use_kernel=False)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)


def test_qr_lookup_multidim_indices_and_concat():
    rng = np.random.default_rng(6)
    (jwr, jwq), (twr, twq) = _dense_pair(rng, 10, 10, 8, "f32")
    idx = rng.integers(0, 100, size=(2, 3, 4)).astype(np.int32)
    for op, width in (("mult", 8), ("add", 8), ("concat", 16)):
        want = jops.qr_lookup(jnp.asarray(idx), jwr, jwq, op=op, interpret=True)
        got = ops.qr_lookup(torch.from_numpy(idx), twr, twq, op=op)
        assert tuple(got.shape) == want.shape == (2, 3, 4, width)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=0)
    # int64 ids of any rank split and reshape the same way
    got64 = ops.qr_lookup(torch.from_numpy(idx.astype(np.int64)), twr, twq)
    torch.testing.assert_close(got64, ops.qr_lookup(torch.from_numpy(idx), twr, twq))


def test_qr_gather_combines_f32_bf16_tables():
    """Single-row combine on bf16 tables: the only rounding is the final
    cast back to bf16."""
    rng = np.random.default_rng(14)
    m, q = 64, 8
    (jwr, jwq), (twr, twq) = _dense_pair(rng, m, q, 128, "bf16")
    idx = rng.integers(0, m * q, size=(16,)).astype(np.int32)
    got = ops.qr_lookup(torch.from_numpy(idx), twr, twq, op="mult")
    assert got.dtype == torch.bfloat16
    want = (np.asarray(jwr, np.float32)[idx % m] * np.asarray(jwq, np.float32)[idx // m])
    np.testing.assert_allclose(_np(got), want, rtol=5e-3, atol=1e-6)
    jax_got = jops.qr_lookup(jnp.asarray(idx), jwr, jwq, op="mult", interpret=True)
    np.testing.assert_array_equal(_np(got), _np(jax_got))


@pytest.mark.parametrize("op", ["mult", "add"])
@pytest.mark.parametrize("m,q,d,n", [(7, 3, 16, 5), (64, 8, 128, 33)])
def test_qr_gather_quant_matches_reference_kernel(op, m, q, d, n):
    rng = np.random.default_rng(3 + m + n)
    (jqr, jqq), (tqr, tqq) = _int8_pair(rng, m, q, d)
    idx = rng.integers(0, m * q, size=(n,)).astype(np.int32)
    meta = [jnp.concatenate([t["scale"].astype(jnp.float32), t["zp"].astype(jnp.float32)],
                            axis=1) for t in (jqr, jqq)]
    want = jax_qr_gather_quant(jnp.asarray(idx % m), jnp.asarray(idx // m), jqr["q"], jqq["q"],
                               *meta, op=op, interpret=True)
    got = ops.qr_lookup(torch.from_numpy(idx), tqr, tqq, op=op)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (n, d)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL["int8"], atol=TOL["int8"])
    plain = ref.qr_gather_quant(torch.from_numpy(idx % m), torch.from_numpy(idx // m),
                                tqr["q"], tqq["q"], tqr["scale"], tqr["zp"], tqq["scale"],
                                tqq["zp"], op=op)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)


def test_qr_lookup_routes_quantized_tables():
    """int8 pair → K5's function; concat and a mixed dense+int8 pair take
    the plain tensor path — all equal to the reference's routing."""
    rng = np.random.default_rng(5)
    (jqr, jqq), (tqr, tqq) = _int8_pair(rng, 40, 5, 16)
    jdense, tdense = _dense_pair(rng, 40, 5, 16, "f32")
    idx = rng.integers(0, 200, size=(2, 9)).astype(np.int32)
    ji, ti = jnp.asarray(idx), torch.from_numpy(idx)
    cases = [((jqr, jqq), (tqr, tqq), "mult", 16), ((jqr, jqq), (tqr, tqq), "add", 16),
             ((jqr, jqq), (tqr, tqq), "concat", 32),
             ((jqr, jdense[1]), (tqr, tdense[1]), "mult", 16),
             ((jdense[0], jqq), (tdense[0], tqq), "add", 16)]
    for jt, tt, op, width in cases:
        want = jops.qr_lookup(ji, *jt, op=op, interpret=True)
        for use_kernel in (True, False):
            got = ops.qr_lookup(ti, *tt, op=op, use_kernel=use_kernel)
            assert got.dtype == torch.float32 and tuple(got.shape) == (2, 9, width)
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    rng = np.random.default_rng(1)
    _, (twr, twq) = _dense_pair(rng, 4, 2, 8, "f32")
    _, (tqr, tqq) = _int8_pair(rng, 4, 2, 8)
    ids = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="mult or add"):
        qr_gather.qr_gather(ids, ids, twr, twq, op="concat")
    with pytest.raises(ValueError, match="mult or add"):
        qr_gather.qr_gather_quant(ids, ids, tqr["q"], tqq["q"], tqr["scale"], tqr["zp"],
                                  tqq["scale"], tqq["zp"], op="concat")

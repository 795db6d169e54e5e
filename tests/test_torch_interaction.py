"""DLRM's pairwise dot interaction (K2): the port's plain versions held
against the reference's Pallas kernel (interpret mode) over the sweep of
``tests/test_kernels.py:49`` — ragged batches included, which the port
takes without padding — and the top MLP's input ``[z, triangle]`` that
``dot_interaction_concat`` writes, against the reference's concatenation
around its kernel.  The CUDA kernel is held against the plain versions in
``test_torch_gpu.py``.

Tolerances (``tests/test_kernels.py:12``): f32 1e-5 (another summation
order over D), bf16 3e-2 (the packed outputs round once to bf16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dlrm_interact as jax_dlrm_interact
from repro_torch.convert import params_from_jax
from repro_torch.kernels import dot_interaction, ops, ref

DTYPES = {"f32": (jnp.float32, dict(rtol=1e-5, atol=1e-5)),
          "bf16": (jnp.bfloat16, dict(rtol=3e-2, atol=3e-2))}
SHAPES = [(4, 27, 16), (13, 5, 32), (8, 27, 64), (1, 3, 8), (256, 27, 16)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,f,d", SHAPES)
def test_plain_matches_reference_kernel(dtype, b, f, d):
    jdt, tol = DTYPES[dtype]
    x = jnp.asarray(np.random.default_rng(5).normal(size=(b, f, d)), jdt)
    want = jax_dlrm_interact(x, use_kernel=True, interpret=True)
    tx = params_from_jax(np.asarray(x), device="cpu")
    got = ref.dot_interaction(tx)
    assert tuple(got.shape) == (b, f * (f - 1) // 2) == want.shape
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    # the kernel entry points take the plain version for CPU tensors
    torch.testing.assert_close(dot_interaction.dot_interaction(tx), got, rtol=0, atol=0)
    torch.testing.assert_close(ops.dlrm_interact(tx), got, rtol=0, atol=0)
    torch.testing.assert_close(ops.dlrm_interact(tx, use_kernel=False), got, rtol=0, atol=0)


def test_packed_order_is_tril():
    """Output p is the (i, j) pair of np.tril_indices(F, k=-1), i > j."""
    x = torch.zeros((1, 4, 4))
    x[0, torch.arange(4), torch.arange(4)] = torch.tensor([1.0, 2.0, 3.0, 5.0])
    x[0, :, 0] += 1.0                    # make every row overlap row 0 only
    out = ref.dot_interaction(x)[0]
    i, j = np.tril_indices(4, k=-1)
    full = (x[0] @ x[0].T).numpy()
    np.testing.assert_array_equal(out.numpy(), full[i, j])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("f", [2, 5, 27])
def test_interact_concat_matches_reference(dtype, f):
    """``[z, tril(X·Xᵀ)]`` for ``X = [z; feats]``: the reference builds X
    and the top MLP's input with two concatenations around its kernel; the
    port's plain version and ``ops.dlrm_interact_concat`` take z and the
    features as they are."""
    jdt, tol = DTYPES[dtype]
    b, d = 6, 16
    rng = np.random.default_rng(f)
    z = jnp.asarray(rng.normal(size=(b, d)), jdt)
    feats = jnp.asarray(rng.normal(size=(b, f - 1, d)), jdt)
    x = jnp.concatenate([z[:, None], feats], axis=1)
    want = jnp.concatenate([z, jax_dlrm_interact(x, use_kernel=True, interpret=True)], -1)
    tz = params_from_jax(np.asarray(z), device="cpu")
    tf = params_from_jax(np.asarray(feats), device="cpu")
    got = ref.dot_interaction_concat(tz, tf)
    assert tuple(got.shape) == (b, d + f * (f - 1) // 2) == want.shape
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    torch.testing.assert_close(got[:, :d], tz, rtol=0, atol=0)     # z is copied exactly
    for use_kernel in (True, False):
        torch.testing.assert_close(ops.dlrm_interact_concat(tz, tf, use_kernel=use_kernel), got,
                                   rtol=0, atol=0)
    torch.testing.assert_close(dot_interaction.dot_interaction_concat(tz, tf), got,
                               rtol=0, atol=0)
    # strided views of one (B, F, D) buffer give the same input
    tx = params_from_jax(np.asarray(x), device="cpu")
    torch.testing.assert_close(ref.dot_interaction_concat(tx[:, 0], tx[:, 1:]), got,
                               rtol=0, atol=0)


def test_plain_triangle_indices_are_made_once_per_size_and_device():
    """The plain version keeps its triangle indices per (F, device), so a
    call copies no index array from the host."""
    ref._tril.cache_clear()
    for _ in range(3):
        ref.dot_interaction(torch.ones((2, 7, 4)))
    ref.dot_interaction(torch.ones((2, 5, 4)))
    info = ref._tril.cache_info()
    assert (info.misses, info.hits) == (2, 2)
    i, j = ref._tril(7, torch.device("cpu"))
    np.testing.assert_array_equal(np.stack([i.numpy(), j.numpy()]), np.tril_indices(7, k=-1))


def test_triangle_indices_cached_under_inference_mode_stay_differentiable():
    """The serving engine dispatches under ``torch.inference_mode``; the
    triangle indices it caches first must still serve a later training
    step, which autograd differentiates through the same plain version."""
    f = 11                                       # a size no other test caches
    with torch.inference_mode():
        ref.dot_interaction(torch.ones((2, f, 4)))
    x = torch.randn((3, f, 4), requires_grad=True)
    ref.dot_interaction(x).sum().backward()
    want = torch.autograd.functional.jacobian(lambda t: ref.dot_interaction(t).sum(), x)
    torch.testing.assert_close(x.grad, want)

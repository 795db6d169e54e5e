"""DLRM's pairwise dot interaction (K2): the port's plain version held
against the reference's Pallas kernel (interpret mode) over the sweep of
``tests/test_kernels.py:49`` — ragged batches included, which the port
takes without padding.  The CUDA kernel is held against the plain version
in ``test_torch_gpu.py``.

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

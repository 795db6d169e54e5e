"""The port's row-wise int8 quantization is bitwise the reference's: the
same f32 table gives the same ``q``, ``scale`` and ``zp``, including an
all-zero row, a constant row and values that land exactly half-way
between two codes (both sides round half to even)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EmbeddingSpec as JSpec
from repro.models.dlrm import DLRMConfig as JCfg
from repro.models.dlrm import dlrm_init as jax_dlrm_init
from repro.serve import quantize as jq
from repro_torch.convert import params_from_jax
from repro_torch.serve import quantize as tq


def _bits(x):
    """Raw bits of a tensor or array, for bitwise comparison."""
    if torch.is_tensor(x):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _assert_same_quant(got: dict, want: dict):
    for k in ("q", "scale", "zp"):
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)


def _half_way_rows():
    s = 2.0 ** -7   # scale (hi - lo) / 252 = 2^-7, exact in bf16
    # zp = -126: w / s + zp lands on .5 for w = (k + .5) s
    a = np.concatenate([[0.0, 252 * s], (np.arange(0, 33) + 0.5) * s])
    # lo = -2.5 s: zp = round(-126 + 2.5) = round(-123.5), itself half-way
    b = np.concatenate([[-2.5 * s, 249.5 * s], (np.arange(-2, 31) + 0.5) * s])
    return np.stack([a, b]).astype(np.float32)


def test_quantize_table_bitwise_with_edge_rows():
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(64, 35)) * np.exp(2.0 * rng.normal(size=(64, 1)))).astype(np.float32)
    w[3] = 0.0                                  # all-zero row
    w[7] = 0.375                                # constant positive row
    w[9] = -1.5e-3                              # constant negative row
    w = np.concatenate([w, _half_way_rows()])
    got = tq.quantize_table(torch.from_numpy(w))
    want = jq.quantize_table(jnp.asarray(w))
    _assert_same_quant(got, want)
    assert got["q"].dtype == torch.int8 and got["zp"].dtype == torch.int8
    assert got["scale"].dtype == torch.bfloat16 and got["scale"].shape == (w.shape[0], 1)
    # the half-way rows really do exercise ties on both sides of zero
    codes = w[-2:] / got["scale"][-2:].float().numpy() + got["zp"][-2:].float().numpy()
    assert (np.abs(codes - np.round(codes)) == 0.5).sum() >= 60
    # per-row error bound of the round-to-nearest grid
    err = np.abs(tq.dequantize_table(got).numpy() - w)
    assert (err <= 0.5 * got["scale"].float().numpy() + 1e-7).all()


def test_quantize_bf16_table_bitwise():
    rng = np.random.default_rng(1)
    w = jnp.asarray(rng.normal(size=(40, 16)), jnp.bfloat16)
    got = tq.quantize_table(params_from_jax(np.asarray(w), device="cpu"))
    _assert_same_quant(got, jq.quantize_table(w))


def _jax_params():
    cfg = JCfg(table_sizes=(100, 500, 33), emb_dim=16, bottom_mlp=(32, 16),
               top_mlp=(32,), embedding=JSpec(kind="qr", num_collisions=4, threshold=40))
    return jax_dlrm_init(jax.random.PRNGKey(0), cfg)


@pytest.mark.parametrize("mode", ["int8", "bf16", "f32"])
def test_quantize_params_and_report_match_reference(mode):
    jp = _jax_params()
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jqp = jq.quantize_params(jp, mode=mode)
    tqp = tq.quantize_params(tp, mode=mode)
    want_leaves = jq.paths_and_leaves(jqp)
    got_tables = tq.table_shapes(tqp)
    assert got_tables == jq.table_shapes(jqp)
    for path, leaf in want_leaves:
        node = tqp
        for part in path.split("/"):
            node = node[int(part)] if isinstance(node, list) else node[part]
        if jq.is_quantized_table(leaf):
            _assert_same_quant(node, leaf)
        else:
            np.testing.assert_array_equal(_bits(node), _bits(leaf), err_msg=path)
    assert tq.memory_report(tp, tqp) == {
        k: v for k, v in jq.memory_report(jp, jqp).items() if k != "placement"}
    assert tq.table_bytes(tqp) == jq.table_bytes(jqp)


def test_row_bytes_and_modes():
    for mode in tq.MODES:
        for dim in (4, 16, 64):
            assert tq.row_bytes(dim, mode) == jq.row_bytes(dim, mode)
    with pytest.raises(ValueError):
        tq.row_bytes(16, "int4")
    with pytest.raises(ValueError):
        tq.quantize_params({}, mode="int4")
    with pytest.raises(ValueError):
        tq.quantize_table(torch.zeros(4))
    assert tq.TABLE_PATTERN == jq.TABLE_PATTERN

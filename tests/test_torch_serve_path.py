"""The fused serving lookup (K4): the port's plain version held against the
reference's Pallas kernel (interpret mode) over the reference's own grid,
the f32-accumulation audit and the ``ops.serve_bag_pool`` routing.  The
CUDA kernel is held against the plain version in ``test_torch_gpu.py``.

Tolerances: f32 and int8 outputs 1e-5 (both sides sum in f32, in another
order); bf16 outputs 3e-2 (one rounding of the pooled bag to bf16,
``tests/test_kernels.py:12``).  The audit holds bf16 tables to rtol 5e-3
against an f32 oracle (``tests/test_kernels.py:84-107``), a bound a bf16
running sum breaks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.serve_path import fused_serve_pool as jax_fused_serve_pool
from repro.serve.quantize import quantize_table as jax_quantize_table
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops, ref, serve_path

TOL = {"f32": 1e-5, "int8": 1e-5, "bf16": 3e-2}


def _t(x):
    return params_from_jax(np.asarray(x), device="cpu")


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else jnp.asarray(x, jnp.float32))


def _tables(rng, rows_a, rows_b, d, mode):
    """Both packages' operands for one table pair in a serving mode:
    jax (w_a, w_b, meta_a, meta_b) and port (w_a, w_b, scale/zp of each)."""
    wa = rng.normal(size=(rows_a, d)).astype(np.float32)
    wb = rng.normal(size=(rows_b, d)).astype(np.float32)
    if mode == "int8":
        qa, qb = jax_quantize_table(jnp.asarray(wa)), jax_quantize_table(jnp.asarray(wb))
        meta = [jnp.concatenate([q["scale"].astype(jnp.float32),
                                 q["zp"].astype(jnp.float32)], axis=1) for q in (qa, qb)]
        jax_ops = (qa["q"], qb["q"], *meta)
        port = dict(w_a=_t(qa["q"]), w_b=_t(qb["q"]), scale_a=_t(qa["scale"]),
                    zp_a=_t(qa["zp"]), scale_b=_t(qb["scale"]), zp_b=_t(qb["zp"]))
        return jax_ops, port
    dt = jnp.bfloat16 if mode == "bf16" else jnp.float32
    ja, jb = jnp.asarray(wa, dt), jnp.asarray(wb, dt)
    return (ja, jb, None, None), dict(w_a=_t(ja), w_b=_t(jb))


def _bags(rng, b, length, hi):
    """(idx, mask) with one fully-empty bag (row b-1) whenever b > 1."""
    idx = rng.integers(0, hi, size=(b, length)).astype(np.int32)
    mask = (rng.random((b, length)) > 0.3).astype(np.float32)
    if b > 1 and length > 0:
        mask[b - 1] = 0.0
    return idx, mask


def _call_port(fn, idx_a, mask, port, idx_b=None, proj=None, op="mult"):
    w_b = port.get("w_b") if idx_b is not None else None
    return fn(idx_a, mask, port["w_a"], idx_b, w_b, port.get("scale_a"), port.get("zp_a"),
              port.get("scale_b") if idx_b is not None else None,
              port.get("zp_b") if idx_b is not None else None, proj, op=op)


# ------------------------------------------------- the reference's grid


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("length", [0, 1, 7, 16])
def test_plain_matches_reference_kernel_grid(mode, length):
    """{f32, bf16, int8} × L ∈ {0, 1, 7, 16} × D ∈ {16, 64, 128} ×
    {uniform, mixed-width} — the grid of tests/test_serve_path.py:71-105:
    QR pair and pre-folded single table, empty bags, the L=0 wave."""
    b, m = 3, 10
    for cell, d_out in enumerate((16, 64, 128)):
        for mixed in (False, True):
            rng = np.random.default_rng(100 * cell + 10 * mixed + length)
            d = d_out // 2 if mixed else d_out
            (wa, wb, ma, mb), port = _tables(rng, m, 5, d, mode)
            proj = rng.normal(size=(d, d_out)).astype(np.float32) if mixed else None
            idx, mask = _bags(rng, b, length, m * 5)
            variants = [(idx % m, idx // m)]
            if d_out == 16:             # single-table (full/hash) variant
                variants.append((idx % m, None))
            for ia, ib in variants:
                want = jax_fused_serve_pool(
                    jnp.asarray(ia), jnp.asarray(mask), wa,
                    idx_b=None if ib is None else jnp.asarray(ib),
                    w_b=None if ib is None else wb, meta_a=ma,
                    meta_b=None if ib is None else mb,
                    proj=None if proj is None else jnp.asarray(proj), interpret=True)
                args = (torch.from_numpy(ia), torch.from_numpy(mask), port)
                kw = dict(idx_b=None if ib is None else torch.from_numpy(ib),
                          proj=None if proj is None else torch.from_numpy(proj))
                got = _call_port(ref.fused_serve_pool, *args, **kw)
                wrapped = _call_port(serve_path.fused_serve_pool, *args, **kw)
                msg = f"{mode} L={length} D={d_out} mixed={mixed} pair={ib is not None}"
                assert tuple(got.shape) == want.shape, msg
                assert str(got.dtype).split(".")[-1] == str(want.dtype), msg
                np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[mode],
                                           atol=TOL[mode], err_msg=msg)
                torch.testing.assert_close(wrapped, got, rtol=0, atol=0)
                if b > 1:               # the empty bag pools (and projects) to 0
                    np.testing.assert_array_equal(_np(got)[b - 1], 0.0)


def test_plain_add_op_and_pair_validation():
    rng = np.random.default_rng(7)
    (wa, wb, ma, mb), port = _tables(rng, 8, 4, 16, "int8")
    idx, mask = _bags(rng, 2, 5, 32)
    want = jax_fused_serve_pool(jnp.asarray(idx % 8), jnp.asarray(mask), wa,
                                idx_b=jnp.asarray(idx // 8), w_b=wb, meta_a=ma,
                                meta_b=mb, op="add")
    got = _call_port(serve_path.fused_serve_pool, torch.from_numpy(idx % 8),
                     torch.from_numpy(mask), port, idx_b=torch.from_numpy(idx // 8),
                     op="add")
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    ia, ib, mk = (torch.from_numpy(idx % 8), torch.from_numpy(idx // 8),
                  torch.from_numpy(mask))
    with pytest.raises(ValueError, match="pairs"):
        serve_path.fused_serve_pool(ia, mk, port["w_a"], idx_b=ib, w_b=None)
    with pytest.raises(ValueError, match="pairs"):
        serve_path.fused_serve_pool(ia, mk, port["w_a"], idx_b=ib, w_b=port["w_b"],
                                    scale_a=port["scale_a"], zp_a=port["zp_a"])
    with pytest.raises(ValueError, match="mult or add"):
        serve_path.fused_serve_pool(ia, mk, port["w_a"], idx_b=ib, w_b=port["w_b"],
                                    scale_a=port["scale_a"], zp_a=port["zp_a"],
                                    scale_b=port["scale_b"], zp_b=port["zp_b"], op="concat")


# ------------------------------------------------- accumulation audit

AUDIT_B, AUDIT_L, AUDIT_D = 8, 16, 128


def _audit_inputs():
    rng = np.random.default_rng(10)
    m, q = 64, 8
    # positive rows: no cancellation, so a bf16 running sum's error compounds
    wr = jnp.asarray(np.abs(rng.normal(size=(m, AUDIT_D))) + 0.5, jnp.bfloat16)
    wq = jnp.asarray(np.abs(rng.normal(size=(q, AUDIT_D))) + 0.5, jnp.bfloat16)
    idx = rng.integers(0, m * q, size=(AUDIT_B, AUDIT_L)).astype(np.int32)
    return m, wr, wq, idx


def _f32_oracle(m, wr, wq, idx):
    r = np.asarray(wr, np.float32)[idx % m] * np.asarray(wq, np.float32)[idx // m]
    return r.sum(axis=1), r


def test_plain_accumulates_f32_at_L16_D128():
    m, wr, wq, idx = _audit_inputs()
    mask = np.ones((AUDIT_B, AUDIT_L), np.float32)
    want, _ = _f32_oracle(m, wr, wq, idx)
    got = ref.fused_serve_pool(torch.from_numpy(idx % m), torch.from_numpy(mask), _t(wr),
                               torch.from_numpy(idx // m), _t(wq))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), want, rtol=5e-3, atol=0)
    jax_got = jax_fused_serve_pool(jnp.asarray(idx % m), jnp.asarray(mask), wr,
                                   idx_b=jnp.asarray(idx // m), w_b=wq)
    np.testing.assert_allclose(_np(got), _np(jax_got), rtol=3e-2, atol=0)


def test_audit_rejects_a_bf16_running_sum():
    """Control: the audit's bound is tight enough that a bf16 running sum
    (one rounding per add) fails it, so the passing test above means f32."""
    m, wr, wq, idx = _audit_inputs()
    want, rows = _f32_oracle(m, wr, wq, idx)
    acc = torch.zeros((AUDIT_B, AUDIT_D), dtype=torch.bfloat16)
    for lane in range(AUDIT_L):
        acc = acc + torch.from_numpy(rows[:, lane]).to(torch.bfloat16)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(_np(acc), want, rtol=5e-3, atol=0)


# ------------------------------------------------- ops routing


def test_serve_bag_pool_routing_matches_reference():
    """ops.serve_bag_pool: kernel route == plain route == the reference on
    the same contract, including the paths the kernel does not cover
    (concat, mixed dense+quant pair)."""
    rng = np.random.default_rng(2)
    wa = rng.normal(size=(12, 8)).astype(np.float32)
    wb = rng.normal(size=(4, 8)).astype(np.float32)
    jqa, jqb = jax_quantize_table(jnp.asarray(wa)), jax_quantize_table(jnp.asarray(wb))
    tqa, tqb = ({k: _t(v) for k, v in q.items()} for q in (jqa, jqb))
    proj = rng.normal(size=(8, 16)).astype(np.float32)
    pc = rng.normal(size=(16, 16)).astype(np.float32)
    idx = rng.integers(0, 48, size=(3, 6)).astype(np.int32)
    mask = (rng.random((3, 6)) > 0.4).astype(np.float32)
    ti, tm, tp = torch.from_numpy(idx), torch.from_numpy(mask), torch.from_numpy(proj)
    ji, jm, jp = jnp.asarray(idx), jnp.asarray(mask), jnp.asarray(proj)
    cases = [
        ((ti, tm, tqa, tqb), (ji, jm, jqa, jqb), {}),
        ((ti, tm, _t(wa), _t(wb)), (ji, jm, jnp.asarray(wa), jnp.asarray(wb)), {}),
        ((ti % 12, tm, tqa, None), (ji % 12, jm, jqa, None), {}),
        ((ti, tm, tqa, _t(wb)), (ji, jm, jqa, jnp.asarray(wb)), {}),      # mixed pair
        ((ti, tm, _t(wa), _t(wb)), (ji, jm, jnp.asarray(wa), jnp.asarray(wb)),
         {"op": "concat"}),
    ]
    for targs, jargs, kw in cases:
        p_t, p_j = (torch.from_numpy(pc), jnp.asarray(pc)) if kw else (tp, jp)
        want = jops.serve_bag_pool(*jargs, proj=p_j, use_kernel=False, **kw)
        for use_kernel in (True, False):
            got = ops.serve_bag_pool(*targs, proj=p_t, use_kernel=use_kernel, **kw)
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)

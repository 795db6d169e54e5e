"""Registry of exemplar kernel programs for the f32-accumulation audit
(ACC-002, ``acc_audit``).

The JAX package's eight programs (``repro/analysis/programs.py``), under
the same names, at the same shapes and with the same worst-case
low-precision operands: bf16 tables wherever the kernel accepts dense
tables, int8 on the quantized paths.  The int8 programs use the port's
quantized layout — a bf16 ``(rows, 1)`` scale and an int8 ``(rows, 1)``
zero point, as ``serve/quantize.py`` stores them — where the reference
builds an f32 ``(rows, 2)`` meta table.

Each program carries what the audit needs beyond ``(fn, args)``:

* ``oracle`` — the same function in f64 on the same operands, as an
  ``Oracle``: its value, the magnitude its accumulation error scales with
  (the sum of the absolute terms), and — for a pool or a contraction with
  nothing after it — the terms themselves, so the audit can build the
  bf16 running sum that must fail the bound;
* ``kernel`` — the launch counter (``kernels.launch_counters``) the
  program launches on a CUDA operand, or None for a plain-only path;
* ``audit`` — where the program pools or contracts, the reference's
  accumulation shape (``tests/test_kernels.py:84-107``: L=16, D=128,
  positive bf16 rows, so no cancellation hides a running sum's error),
  as ``(fn, args)`` for the program's function at that shape.

The registry is the extension point: a new kernel family registers its
exemplar here and is audited on every analyzer run from then on.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

__all__ = ["KernelProgram", "Oracle", "kernel_programs", "AUDIT_B", "AUDIT_L", "AUDIT_D"]

AUDIT_B, AUDIT_L, AUDIT_D = 8, 16, 128


class Oracle(NamedTuple):
    value: torch.Tensor                 # f64, fn's exact result
    magnitude: torch.Tensor             # f64, sum of |terms| per output
    terms: Optional[torch.Tensor] = None  # f64 terms, value = terms.sum(dim)
    dim: int = 1


@dataclasses.dataclass(frozen=True)
class KernelProgram:
    name: str
    build: Callable[[torch.device], tuple]        # device -> (fn, args)
    oracle: Callable[..., Oracle]                  # args -> f64 oracle
    kernel: Optional[str] = None                   # launch counter, CUDA
    audit: Optional[Callable[[torch.device], tuple]] = None  # device -> (fn, args)
    notes: str = ""


# ------------------------------------------------------------- operands


def _t(array, device, dtype=None):
    t = torch.as_tensor(np.asarray(array))
    return t.to(device=device, dtype=dtype or t.dtype)


def _ids(rng, high, shape, device):
    return _t(rng.integers(0, high, shape), device, torch.int32)


def _mask(rng, shape, device):
    return _t(rng.integers(0, 2, shape), device, torch.float32)


def _normal(rng, shape, device, dtype=torch.bfloat16):
    return _t(rng.normal(size=shape), device, dtype)


def _positive(rng, shape, device):
    """|N(0, 1)| + 0.5 in bf16: no cancellation, so a running sum's error
    compounds past the audit's tolerance."""
    return _t(np.abs(rng.normal(size=shape)) + 0.5, device, torch.bfloat16)


def _int8_table(rng, rows, d, device):
    """(q, scale, zp) in the port's quantized layout."""
    return (_t(rng.integers(-127, 128, (rows, d)), device, torch.int8),
            _t(rng.uniform(0.01, 0.1, (rows, 1)), device, torch.bfloat16),
            _t(rng.integers(-16, 17, (rows, 1)), device, torch.int8))


def _f64(x):
    return None if x is None else x.detach().to("cpu", torch.float64)


def _long(x):
    return x.detach().to("cpu", torch.int64)


def _deq(w, scale=None, zp=None):
    """f64 rows of a dense table, or ``(q - zp) * scale`` of an int8 one."""
    w = _f64(w)
    return w if scale is None else (w - _f64(zp)) * _f64(scale)


def _combine(a, b, op):
    if op == "concat":
        return torch.cat([a, b], dim=-1)
    return a * b if op == "mult" else a + b


def _pool(terms, dim=1) -> Oracle:
    return Oracle(terms.sum(dim), terms.abs().sum(dim), terms, dim)


# -------------------------------------------------------------- programs
# each program draws its operands from its own numpy seed (the reference's),
# on the CPU, and moves them to the device: every device audits the same data


def _bf16_qr_bag_kernel(device):
    from ..kernels.embedding_bag import qr_embedding_bag
    rng = np.random.default_rng(0)
    b, l, m, q, d = 4, 8, 16, 8, 32
    args = (_ids(rng, m, (b, l), device), _ids(rng, q, (b, l), device),
            _mask(rng, (b, l), device), _normal(rng, (m, d), device),
            _normal(rng, (q, d), device))

    def fn(rem, quo, mask, w_rem, w_quo):
        return qr_embedding_bag(rem, quo, mask, w_rem, w_quo, op="mult")
    return fn, args


def _qr_bag_oracle(rem, quo, mask, w_rem, w_quo):
    rows = _f64(w_rem)[_long(rem)] * _f64(w_quo)[_long(quo)]
    return _pool(_f64(mask)[..., None] * rows)


def _qr_bag_audit(device):
    rng = np.random.default_rng(10)
    m, q = 64, 8
    idx = rng.integers(0, m * q, (AUDIT_B, AUDIT_L))
    return (_t(idx % m, device, torch.int32), _t(idx // m, device, torch.int32),
            torch.ones((AUDIT_B, AUDIT_L), device=device),
            _positive(rng, (m, AUDIT_D), device), _positive(rng, (q, AUDIT_D), device))


def _bf16_qr_gather_kernel(device):
    from ..kernels.qr_gather import qr_gather
    rng = np.random.default_rng(1)
    n, m, q, d = 32, 16, 8, 32
    args = (_ids(rng, m, (n,), device), _ids(rng, q, (n,), device),
            _normal(rng, (m, d), device), _normal(rng, (q, d), device))

    def fn(rem, quo, w_rem, w_quo):
        return qr_gather(rem, quo, w_rem, w_quo, op="add")
    return fn, args


def _qr_gather_oracle(rem, quo, w_rem, w_quo):
    a, b = _f64(w_rem)[_long(rem)], _f64(w_quo)[_long(quo)]
    return Oracle(a + b, a.abs() + b.abs())


def _int8_qr_gather_kernel(device):
    from ..kernels.qr_gather import qr_gather_quant
    rng = np.random.default_rng(2)
    n, m, q, d = 32, 16, 8, 32
    rem, quo = _ids(rng, m, (n,), device), _ids(rng, q, (n,), device)
    q_rem, s_rem, z_rem = _int8_table(rng, m, d, device)
    q_quo, s_quo, z_quo = _int8_table(rng, q, d, device)

    def fn(rem, quo, q_rem, q_quo, s_rem, z_rem, s_quo, z_quo):
        return qr_gather_quant(rem, quo, q_rem, q_quo, s_rem, z_rem, s_quo, z_quo,
                               op="mult")
    return fn, (rem, quo, q_rem, q_quo, s_rem, z_rem, s_quo, z_quo)


def _qr_gather_quant_oracle(rem, quo, q_rem, q_quo, s_rem, z_rem, s_quo, z_quo):
    value = _deq(q_rem, s_rem, z_rem)[_long(rem)] * _deq(q_quo, s_quo, z_quo)[_long(quo)]
    return Oracle(value, value.abs())


def _serve_fn():
    from ..kernels.serve_path import fused_serve_pool

    def fn(idx_a, mask, w_a, idx_b, w_b, s_a, z_a, s_b, z_b, proj):
        return fused_serve_pool(idx_a, mask, w_a, idx_b, w_b, s_a, z_a, s_b, z_b, proj,
                                op="mult")
    return fn


def _bf16_fused_serve_kernel(device):
    rng = np.random.default_rng(3)
    b, l, m, d, d_out = 4, 8, 16, 16, 32
    args = (_ids(rng, m, (b, l), device), _mask(rng, (b, l), device),
            _normal(rng, (m, d), device), None, None, None, None, None, None,
            _normal(rng, (d, d_out), device))
    return _serve_fn(), args


def _int8_fused_serve_kernel(device):
    rng = np.random.default_rng(4)
    b, l, m, d = 4, 8, 16, 32
    idx_a, idx_b = _ids(rng, m, (b, l), device), _ids(rng, m, (b, l), device)
    mask = _mask(rng, (b, l), device)
    q_a, s, z = _int8_table(rng, m, d, device)
    q_b = _t(rng.integers(-127, 128, (m, d)), device, torch.int8)
    # one scale / zero-point column for both tables, as the reference
    # shares one meta table between them
    return _serve_fn(), (idx_a, mask, q_a, idx_b, q_b, s, z, s, z, None)


def _serve_oracle(idx_a, mask, w_a, idx_b, w_b, s_a, z_a, s_b, z_b, proj):
    rows = _deq(w_a, s_a, z_a)[_long(idx_a)]
    if idx_b is not None:
        rows = rows * _deq(w_b, s_b, z_b)[_long(idx_b)]
    pooled = _pool(_f64(mask)[..., None] * rows)
    if proj is None:
        return pooled
    p = _f64(proj)
    return Oracle(pooled.value @ p, pooled.magnitude @ p.abs())


def _serve_single_audit(device):
    rng = np.random.default_rng(11)
    m = 512
    return (_ids(rng, m, (AUDIT_B, AUDIT_L), device),
            torch.ones((AUDIT_B, AUDIT_L), device=device),
            _positive(rng, (m, AUDIT_D), device), None, None, None, None, None, None, None)


def _serve_pair_audit(device):
    rem, quo, mask, w_rem, w_quo = _qr_bag_audit(device)
    return rem, mask, w_rem, quo, w_quo, None, None, None, None, None


def _bf16_qr_bag_plain(device):
    from ..kernels.ops import qr_bag_lookup
    rng = np.random.default_rng(5)
    b, l, m, q, d = 4, 8, 16, 8, 32
    args = (_ids(rng, m * q, (b, l), device), _mask(rng, (b, l), device),
            _normal(rng, (m, d), device), _normal(rng, (q, d), device))

    def fn(idx, mask, w_rem, w_quo):
        return qr_bag_lookup(idx, mask, w_rem, w_quo, op="concat", use_kernel=False)
    return fn, args


def _concat_bag_oracle(idx, mask, w_rem, w_quo):
    idx, m = _long(idx), w_rem.shape[0]
    rows = _combine(_f64(w_rem)[idx % m], _f64(w_quo)[idx // m], "concat")
    return _pool(_f64(mask)[..., None] * rows)


def _concat_bag_audit(device):
    rng = np.random.default_rng(12)
    m, q = 64, 8
    return (_ids(rng, m * q, (AUDIT_B, AUDIT_L), device),
            torch.ones((AUDIT_B, AUDIT_L), device=device),
            _positive(rng, (m, AUDIT_D), device), _positive(rng, (q, AUDIT_D), device))


def _bag_pool_fn(size, d, c):
    from ..core.compositional import bag_pool, qr_embedding
    mod = qr_embedding(size, d, num_collisions=c, op="mult", param_dtype=torch.bfloat16)

    def fn(params, idx, mask):
        return bag_pool(mod, params, idx, mask=mask)
    return mod, fn


def _bf16_bag_pool(device):
    rng = np.random.default_rng(6)
    size, d, b, l = 96, 32, 4, 8
    mod, fn = _bag_pool_fn(size, d, 4)
    params = {k: v.to(device) for k, v in
              mod.init(torch.Generator().manual_seed(0), "cpu").items()}
    return fn, (params, _ids(rng, size, (b, l), device), _mask(rng, (b, l), device))


def _bag_pool_oracle(params, idx, mask):
    # the module combines its rows in the table dtype (one rounding of each
    # exact product), as the reference's does; only the pool is audited
    idx, m = _long(idx), params["table_0"].shape[0]
    rows = _f64(params["table_0"])[idx % m] * _f64(params["table_1"])[idx // m]
    rows = rows.to(params["table_0"].dtype).to(torch.float64)
    return _pool(_f64(mask)[..., None] * rows, dim=-2)


def _bag_pool_audit(device):
    rng = np.random.default_rng(13)
    size, c = 512, 8
    m = size // c
    params = {"table_0": _positive(rng, (m, AUDIT_D), device),
              "table_1": _positive(rng, (c, AUDIT_D), device)}
    return (params, _ids(rng, size, (AUDIT_B, AUDIT_L), device),
            torch.ones((AUDIT_B, AUDIT_L), device=device))


def _bf16_dot_interaction(device):
    from ..kernels.dot_interaction import dot_interaction
    rng = np.random.default_rng(7)
    b, f, d = 8, 4, 16
    return dot_interaction, (_normal(rng, (b, f, d), device),)


def _dot_oracle(x):
    x = _f64(x)
    i, j = np.tril_indices(x.shape[1], k=-1)
    return _pool(x[:, i] * x[:, j], dim=-1)


def _dot_audit(device):
    # F=16 features of width D=128: every dot contracts 128 positive terms
    rng = np.random.default_rng(14)
    return (_positive(rng, (AUDIT_B, AUDIT_L, AUDIT_D), device),)


def _at(build, args):
    """The program's ``fn`` at the accumulation shape ``args(device)``."""
    return lambda device: (build(device)[0], args(device))


def _bag_pool_at_audit_shape(device):
    return _bag_pool_fn(512, AUDIT_D, 8)[1], _bag_pool_audit(device)


def kernel_programs() -> list[KernelProgram]:
    """Every serve/train-kernel-reachable program the f32-accumulation
    audit certifies, with worst-case bf16/int8 operands."""
    return [
        KernelProgram("embedding_bag.qr_embedding_bag[bf16]",
                      _bf16_qr_bag_kernel, _qr_bag_oracle, "qr_embedding_bag",
                      _at(_bf16_qr_bag_kernel, _qr_bag_audit),
                      "fused QR bag kernel (K3), bf16 tables"),
        KernelProgram("qr_gather.qr_gather[bf16]", _bf16_qr_gather_kernel,
                      _qr_gather_oracle, "qr_gather", None,
                      "fused QR gather kernel (K1), bf16 tables"),
        KernelProgram("qr_gather.qr_gather_quant[int8]",
                      _int8_qr_gather_kernel, _qr_gather_quant_oracle,
                      "qr_gather_quant", None,
                      "fused int8-dequant QR gather kernel (K5)"),
        KernelProgram("serve_path.fused_serve_pool[bf16+proj]",
                      _bf16_fused_serve_kernel, _serve_oracle, "fused_serve_pool",
                      _at(_bf16_fused_serve_kernel, _serve_single_audit),
                      "fused serve kernel (K4), bf16 table + projection"),
        KernelProgram("serve_path.fused_serve_pool[int8 qr]",
                      _int8_fused_serve_kernel, _serve_oracle, "fused_serve_pool",
                      _at(_int8_fused_serve_kernel, _serve_pair_audit),
                      "fused serve kernel (K4), quantized QR pair"),
        KernelProgram("ops.qr_bag_lookup[bf16 jnp]", _bf16_qr_bag_plain,
                      _concat_bag_oracle, None, _at(_bf16_qr_bag_plain, _concat_bag_audit),
                      "plain bag path (concat op), bf16 tables"),
        KernelProgram("compositional.bag_pool[bf16 qr]", _bf16_bag_pool,
                      _bag_pool_oracle, None, _bag_pool_at_audit_shape,
                      "model-side pooled lookup, bf16 QR module"),
        KernelProgram("dot_interaction.dot_interaction[bf16]",
                      _bf16_dot_interaction, _dot_oracle, "dot_interaction",
                      _at(_bf16_dot_interaction, _dot_audit),
                      "DLRM pairwise-dot kernel (K2), bf16 features"),
    ]

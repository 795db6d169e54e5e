"""Mamba2 block via the SSD (state-space duality) chunked algorithm: the
JAX package's ``nn/ssm.py``, the same math on tensors.

Recurrence (per head h, state (N, P)):
    S_t = exp(dt_t·A_h) · S_{t-1} + dt_t · B_t ⊗ x_t
    y_t = C_t · S_t + D_h · x_t

Training / prefill use the chunked SSD form: within a chunk of length Q
the quadratic "attention-like" term ``C_i·B_j · exp(cs_i−cs_j) · dt_j`` is
a masked (Q, Q) product in f32; across chunks a Python loop over the
chunks carries the (H, N, P) state (the reference's ``lax.scan``).  Every
three-operand einsum of the reference is a masked elementwise product
followed by a two-operand product, so no ``(B, nc, Q, Q, H, P)`` tensor is
ever built.  The decay mask is applied to the exponent (``exp(−inf) = 0``)
rather than to its result: the forward values are the reference's, and
the gradient stays finite where ``cs_i − cs_j`` (``j > i``, masked out)
would overflow ``exp`` in f32 — the reference's ``where(mask, exp(.), 0)``
passes ``0 · inf = NaN`` back to the exponent there.

Decode is the O(1) recurrence with a (H, N, P) f32 state cache and a
(d_conv−1)-deep cache of the raw (pre-conv) projections, both updated in
place (the reference returns updated copies; the function is the same).
Decode and teacher forcing compute one function with other roundings:
the decode conv is one product over the window, the prefill conv
``d_conv`` shifted adds in the compute dtype.

The chunked block keeps the reference's ``constrain`` calls (the identity
on plain tensors; on DTensors the input and output batch-split, the input
projection's features over ``model``).  The products are
plain ``torch`` einsums: the reference computes them outside any Pallas
kernel.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as tf

from ..dist.sharding import constrain, constrain_batch, kernel_map
from .layers import dense, dense_init

__all__ = ["SSMConfig", "ssm_init", "ssm_apply", "ssm_decode", "ssm_make_cache"]

# The SSD's f32 products stay true f32 on the card: no TF32 in float32
# matrix products (PyTorch's default, stated here so the block does not
# depend on another module to set it).
torch.backends.cuda.matmul.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128
    expand: int = 2
    d_conv: int = 4
    headdim: int = 64
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.headdim

    @property
    def d_xbc(self) -> int:
        return self.d_inner + 2 * self.d_state  # x, B, C (single group)


def _a_log(n_heads: int) -> torch.Tensor:
    """``log(linspace(1, 16, H))`` in f32 on the CPU, as the compiled
    reference computes it: ``jnp.linspace``'s ``start·(1 − t) + stop·t``
    with ``t = i · (1 / (H − 1))`` (XLA turns the division by a constant
    into a product by its reciprocal), each step rounded to f32, and the
    logarithm rounded once from f64.  Equal to the reference's leaf where
    XLA folds the constant (up to 32 heads); where it computes the
    logarithm at run time (48 heads and more), its own approximation is
    within one f32 ulp of this."""
    if n_heads == 1:
        return torch.zeros((1,), dtype=torch.float32)
    t = torch.arange(n_heads - 1, dtype=torch.float32) * (
        torch.tensor(1.0, dtype=torch.float32) / (n_heads - 1))
    lin = torch.cat([1.0 * (1.0 - t) + 16.0 * t, torch.tensor([16.0])])
    return torch.log(lin.to(torch.float64)).to(torch.float32)


def ssm_init(generator, cfg: SSMConfig, param_dtype, device="cuda"):
    """The reference's tree, drawn in its key order (``in_proj``, ``conv_w``,
    ``out_proj``).  ``A_log``, ``D`` and ``dt_bias`` are f32 whatever
    ``param_dtype``; ``A_log`` is computed on the CPU and copied, so every
    device holds the same bits."""
    d_in_proj = 2 * cfg.d_inner + 2 * cfg.d_state + cfg.n_heads  # z, x, B, C, dt
    in_proj = dense_init(generator, cfg.d_model, d_in_proj, param_dtype, device=device)
    conv_w = torch.randn((cfg.d_conv, cfg.d_xbc), generator=generator, device=device,
                         dtype=torch.float32)
    conv_w = (conv_w * math.sqrt(1.0 / cfg.d_conv)).to(param_dtype)
    out_proj = dense_init(generator, cfg.d_inner, cfg.d_model, param_dtype, device=device)
    if torch.device(device).type == "meta":
        a_log = torch.empty((cfg.n_heads,), dtype=torch.float32, device=device)
    else:
        a_log = _a_log(cfg.n_heads).to(device)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((cfg.d_xbc,), dtype=param_dtype, device=device),
        "A_log": a_log,
        "D": torch.ones((cfg.n_heads,), dtype=torch.float32, device=device),
        "dt_bias": torch.full((cfg.n_heads,), -2.0, dtype=torch.float32, device=device),
        "norm_g": torch.ones((cfg.d_inner,), dtype=param_dtype, device=device),
        "out_proj": out_proj,
    }


def _split_proj(zxbcdt, cfg: SSMConfig):
    di = cfg.d_inner
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di : di + cfg.d_xbc]
    dt = zxbcdt[..., di + cfg.d_xbc :]
    return z, xbc, dt


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) + log1p(exp(−|x|))``
    at every x (``torch.nn.functional.softplus`` returns x itself above its
    threshold of 20)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def _gated_norm(y, z, g, eps: float = 1e-6):
    """``y · silu(z)`` in y's dtype, then an RMS norm in f32 with gain ``g``,
    cast once back to y's dtype."""
    y = y * tf.silu(z.to(y.dtype))
    y32 = y.to(torch.float32)
    y32 = y32 * torch.rsqrt(torch.mean(y32 * y32, dim=-1, keepdim=True) + eps)
    return (y32 * g.to(torch.float32)).to(y.dtype)


def _causal_conv(xbc, conv_w, conv_b):
    """Depthwise causal conv over the sequence (dim 1), window K, as K
    shifted adds, each rounded in ``xbc``'s dtype, then silu."""
    k, s = conv_w.shape[0], xbc.shape[1]
    out = xbc * conv_w[-1]
    for i in range(1, k):
        shifted = tf.pad(xbc, (0, 0, i, 0))[:, :s]
        out = out + shifted * conv_w[-1 - i]
    return tf.silu(out + conv_b)


def ssm_apply(params, u, cfg: SSMConfig, compute_dtype, *, return_state: bool = False):
    """u: (B, S, d_model) → (B, S, d_model), any S (padded internally to the
    chunk).  With ``return_state``: (out, {"ssm": the final (B, H, N, P)
    f32 state, "conv": the raw projections of the last ``d_conv − 1``
    steps}), a decode cache; S must then be at least ``d_conv − 1``."""
    b, s, _ = u.shape
    if return_state and s < cfg.d_conv - 1:
        raise ValueError(f"a prompt of {s} tokens is shorter than the conv window's "
                         f"d_conv - 1 = {cfg.d_conv - 1} steps that the decode cache holds")
    zxbcdt = constrain(dense(params["in_proj"], constrain_batch(u), compute_dtype),
                       "dp", None, "model")
    z, xbc_raw, dt_raw = _split_proj(zxbcdt, cfg)
    # on DTensors the conv (its shifts pad a split sequence) runs on each
    # rank's rows with the channels whole
    xbc = kernel_map(_causal_conv, (xbc_raw,), whole=(params["conv_w"].to(compute_dtype),
                                                      params["conv_b"].to(compute_dtype)))
    di, ds, nh, p = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.headdim
    x = xbc[..., :di].reshape(b, s, nh, p)
    bmat = xbc[..., di : di + ds]                                   # (B, S, N)
    cmat = xbc[..., di + ds :]                                      # (B, S, N)

    dt = _softplus(dt_raw.to(torch.float32) + params["dt_bias"])    # (B, S, H)
    a = -torch.exp(params["A_log"])                                 # (H,) < 0
    da = dt * a                                                     # (B, S, H) < 0

    q = min(cfg.chunk, s)
    pad = (-s) % q
    # padded positions must be identity steps (decay 1, zero input) so the
    # final state returned for prefill is exact: dt = 0 after the softplus
    # achieves both
    if pad:
        x = tf.pad(x, (0, 0, 0, 0, 0, pad))
        bmat = tf.pad(bmat, (0, 0, 0, pad))
        cmat = tf.pad(cmat, (0, 0, 0, pad))
        dt = tf.pad(dt, (0, 0, 0, pad))
        da = tf.pad(da, (0, 0, 0, pad))
    nc = (s + pad) // q
    xc = x.reshape(b, nc, q, nh, p)
    bc = bmat.reshape(b, nc, q, ds).to(torch.float32)
    cc = cmat.reshape(b, nc, q, ds).to(torch.float32)
    dtc = dt.reshape(b, nc, q, nh)
    dac = da.reshape(b, nc, q, nh)

    # inclusive, (B,nc,Q,H); on DTensors on each rank's rows (the
    # backward's flip has no sharding strategy in every PyTorch)
    cs = kernel_map(lambda t: torch.cumsum(t, dim=2), (dac,))
    # --- intra-chunk (quadratic within Q): the decay masked in its exponent
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)                    # f32 operands, f32 product
    mask = torch.ones((q, q), dtype=torch.bool, device=u.device).tril()
    decay = torch.exp(torch.where(mask[:, :, None], cs[:, :, :, None, :] - cs[:, :, None, :, :],
                                  -torch.inf))                      # (B,nc,Q,Q,H)
    xdt = xc.to(torch.float32) * dtc[..., None]                     # (B,nc,Q,H,P)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", cb[..., None] * decay, xdt)

    # --- inter-chunk state scan
    seg = torch.exp(cs[:, :, -1:, :] - cs)                          # decay from t to chunk end
    chunk_states = torch.einsum("bcjn,bcjhp->bchnp", bc, seg[..., None] * xdt)  # (B,nc,H,N,P)
    chunk_decay = torch.exp(cs[:, :, -1, :])                        # (B,nc,H)
    state = torch.zeros((b, nh, ds, p), dtype=torch.float32, device=u.device)
    prevs = []
    for c in range(nc):
        prevs.append(state)                                         # the state before chunk c
        state = state * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    s_prevs = torch.stack(prevs, dim=1)                             # (B,nc,H,N,P)
    instate_decay = torch.exp(cs)                                   # boundary state to pos i
    y_inter = torch.einsum("bcin,bchnp->bcihp", cc, s_prevs) * instate_decay[..., None]

    y = y_intra + y_inter + params["D"][:, None] * xc.to(torch.float32)
    y = y.reshape(b, nc * q, di)[:, :s].to(compute_dtype)
    y = _gated_norm(y, z, params["norm_g"])
    out = constrain_batch(dense(params["out_proj"], y, compute_dtype))
    if return_state:
        # the conv cache holds the raw (pre-conv) projections of the last K-1 steps
        return out, {"ssm": state, "conv": xbc_raw[:, s - (cfg.d_conv - 1):]}
    return out


def ssm_make_cache(batch, cfg: SSMConfig, dtype, device="cuda"):
    """The decode cache: the f32 state ``(batch, H, N, P)`` and the conv
    window ``(batch, d_conv − 1, d_xbc)`` in ``dtype``, zero."""
    return {
        "ssm": torch.zeros((batch, cfg.n_heads, cfg.d_state, cfg.headdim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_xbc), dtype=dtype, device=device),
    }


def ssm_decode(params, u, cfg: SSMConfig, compute_dtype, cache):
    """Single-token step.  u: (B, 1, d_model) → (out (B, 1, d_model),
    cache), the cache's two tensors updated in place."""
    b = u.shape[0]
    zxbcdt = dense(params["in_proj"], u, compute_dtype)
    z, xbc_t, dt_raw = _split_proj(zxbcdt[:, 0], cfg)
    conv = cache["conv"]
    window = torch.cat([conv, xbc_t[:, None, :].to(conv.dtype)], dim=1)
    xbc = tf.silu(torch.einsum("bkc,kc->bc", window.to(compute_dtype),
                               params["conv_w"].to(compute_dtype))
                  + params["conv_b"].to(compute_dtype))
    conv.copy_(window[:, 1:])

    di, ds, nh, p = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.headdim
    x = xbc[:, :di].reshape(b, nh, p).to(torch.float32)
    bvec = xbc[:, di : di + ds].to(torch.float32)
    cvec = xbc[:, di + ds :].to(torch.float32)
    dt = _softplus(dt_raw.to(torch.float32) + params["dt_bias"])    # (B, H)
    a = -torch.exp(params["A_log"])
    dec = torch.exp(dt * a)                                         # (B, H)
    state = cache["ssm"]
    state.mul_(dec[..., None, None]).add_(
        bvec[:, None, :, None] * (dt[..., None] * x)[:, :, None, :])
    y = torch.einsum("bn,bhnp->bhp", cvec, state) + params["D"][:, None] * x
    y = y.reshape(b, di).to(compute_dtype)
    y = _gated_norm(y[:, None, :], z[:, None, :], params["norm_g"])
    return dense(params["out_proj"], y, compute_dtype), cache

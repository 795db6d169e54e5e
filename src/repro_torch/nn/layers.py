"""Shared neural-net layers: functions on tensors, the reference's math.

Conventions, as in the JAX package's ``nn/layers.py``:
  * params are plain nested dicts of tensors;
  * ``*_init`` take an explicit ``torch.Generator``, the shapes and the
    device; the apply functions are pure functions of their operands;
  * weights are stored in ``param_dtype`` and cast to ``compute_dtype`` at
    use (mixed precision);
  * attention is memory-linear: a two-level (q-block × kv-block) loop with
    a running max and denominator ("flash"), so a long prefill never
    materialises an S×S score matrix, and a backward that recomputes the
    score blocks from ``(q, k, v, out, lse)`` (``_FlashFn``).

Where the reference computes in f32 and stores in the compute dtype, so
does the port: attention scores and the probability-value products are
f32 products of the (exactly widened) operands, as ``einsum(...,
preferred_element_type=float32)`` is; ``rope`` and ``rmsnorm`` work in f32
and cast once.  The attention and MLP products are plain ``torch.einsum``
/ ``@``: the reference computes them outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as tf

from ..dist.sharding import (axis_sizes, constrain, constrain_batch, dp_entry, is_dtensor,
                             model_divides, replicate_dim, to_placements)

__all__ = [
    "dense_init", "dense", "rmsnorm_init", "rmsnorm", "mlp_init", "mlp",
    "rope", "attention_init", "attention", "make_cache", "AttnConfig",
    "flash_attention", "cross_kv", "attention_with_kv",
]


# ---------------------------------------------------------------- basics


def dense_init(generator, d_in, d_out, param_dtype, scale: float | None = None,
               device="cuda"):
    scale = (1.0 / d_in) ** 0.5 if scale is None else scale
    w = torch.randn((d_in, d_out), generator=generator, device=device, dtype=torch.float32)
    return {"w": (w * scale).to(param_dtype)}


def dense(params, x, compute_dtype):
    return x.to(compute_dtype) @ params["w"].to(compute_dtype)


def rmsnorm_init(d, param_dtype, device="cuda"):
    return {"g": torch.ones((d,), dtype=param_dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.to(torch.float32)
    x32 = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * params["g"].to(torch.float32)).to(dt)


def mlp_init(generator, d_model, d_ff, param_dtype, kind: str = "swiglu", device="cuda"):
    # the reference splits its key three ways (k1 wi, k2 wo, k3 wg): draw in
    # that order from one generator
    wi = dense_init(generator, d_model, d_ff, param_dtype, device=device)
    p = {"wo": dense_init(generator, d_ff, d_model, param_dtype, device=device), "wi": wi}
    if kind == "swiglu":
        p["wg"] = dense_init(generator, d_model, d_ff, param_dtype, device=device)
    return p


def mlp(params, x, compute_dtype, kind: str = "swiglu"):
    """Transformer FFN: ``wo(act(wi x))``, with ``silu(wg x) * wi x`` for
    swiglu, the tanh-approximated gelu (``jax.nn.gelu``'s default) or relu.
    On DTensors the reference's pinning: batch-sharded input, hidden
    sharded over ``model``, batch-sharded output (weights gather, the
    activations stay put)."""
    x = constrain_batch(x)
    h = dense(params["wi"], x, compute_dtype)
    if kind == "swiglu":
        h = tf.silu(dense(params["wg"], x, compute_dtype)) * h
    elif kind == "gelu":
        h = tf.gelu(h, approximate="tanh")
    else:
        h = torch.relu(h)
    if h.dim() == 3:
        h = constrain(h, "dp", None, "model")
    return constrain_batch(dense(params["wo"], h, compute_dtype))


# ---------------------------------------------------------------- rope


def rope(x, positions, theta: float = 1e4):
    """Rotary embedding. x: (..., S, H, Dh); positions: (..., S).  The
    angles and the rotation in f32, one cast to ``x``'s dtype."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = positions.to(torch.float32)[..., None, None] * freqs  # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- flash attention


def _attend_block(q, k, v, m, l, acc, mask, v_dtype):
    """One (q-block, kv-block) flash step.  q: (B,Q,Hk,G,D), k/v: (B,K,Hk,D),
    all f32 (widened from the compute dtype); the probabilities round to
    ``v_dtype`` before they multiply v, as the reference's ``p.astype``."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhgd,bkhd->bhgqk", q, k)
    s = s * scale + mask  # mask: (Q, K) additive, broadcast
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v_dtype).to(torch.float32), v)
    acc_new = acc * alpha[..., None] + pv
    return m_new, l_new, acc_new


def _pad_seq(x, pad, value=0.0):
    """``x`` (B, S, ...) padded by ``pad`` rows at the end of dim 1."""
    if not pad:
        return x
    return tf.pad(x, (0, 0) * (x.dim() - 2) + (0, pad), value=value)


def _pad_to_blocks(q, k, v, block_q, block_k):
    sq, sk = q.shape[1], k.shape[1]
    nq, nk = -(-sq // block_q), -(-sk // block_k)
    q = _pad_seq(q, nq * block_q - sq)
    k = _pad_seq(k, nk * block_k - sk)
    v = _pad_seq(v, nk * block_k - sk)
    return q, k, v, nq, nk


def _flash_fwd_impl(q, k, v, causal, q_offset, block_q, block_k, kv_len):
    b, sq, h, dh = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = h // hkv
    dev = q.device
    block_q, block_k = min(block_q, sq), min(block_k, sk)
    qp_, kp_, vp_, nq, nk = _pad_to_blocks(q, k, v, block_q, block_k)
    qg = qp_.reshape(b, nq, block_q, hkv, g, dh).to(torch.float32)
    kg = kp_.reshape(b, nk, block_k, hkv, dh).to(torch.float32)
    vg = vp_.reshape(b, nk, block_k, hkv, dv).to(torch.float32)
    q_pos = q_offset + torch.arange(nq * block_q, device=dev).reshape(nq, block_q)
    k_pos = torch.arange(nk * block_k, device=dev).reshape(nk, block_k)
    valid_k = sk if kv_len is None else kv_len
    zeros = torch.zeros((block_q, block_k), dtype=torch.float32, device=dev)
    outs, lses = [], []
    for qi in range(nq):
        qblk, qp = qg[:, qi], q_pos[qi]
        m = torch.full((b, hkv, g, block_q), -torch.inf, dtype=torch.float32, device=dev)
        l = torch.zeros((b, hkv, g, block_q), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, g, block_q, dv), dtype=torch.float32, device=dev)
        for kj in range(nk):
            kp = k_pos[kj]
            mask = zeros
            if causal:
                mask = torch.where(qp[:, None] >= kp[None, :], 0.0, -torch.inf)
            mask = torch.where(kp[None, :] < valid_k, mask, -torch.inf)
            m, l, acc = _attend_block(qblk, kg[:, kj], vg[:, kj], m, l, acc, mask, v.dtype)
        out = acc / torch.clamp(l, min=1e-30)[..., None]             # (B,Hkv,G,Q,Dv)
        lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)), torch.inf)
        outs.append(out.permute(0, 3, 1, 2, 4))                     # (B,Q,Hkv,G,Dv)
        lses.append(lse)
    out = torch.cat(outs, dim=1).reshape(b, nq * block_q, h, dv)
    lse = torch.cat(lses, dim=-1)                                   # (B,Hkv,G,nq*Q)
    return out[:, :sq].to(q.dtype), lse[..., :sq]


def _flash_bwd(causal, q_offset, block_q, block_k, res, dout):
    """Flash backward: recompute the score blocks from (q, k, v, out, lse),
    one kv block at a time.  The residuals are O(S·D), which keeps the
    backward memory-linear."""
    q, k, v, out, lse = res
    b, sq, h, dh = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = h // hkv
    dev = q.device
    scale = dh ** -0.5
    bq, bk = min(block_q, sq), min(block_k, sk)
    qp_, kp_, vp_, nq, nk = _pad_to_blocks(q, k, v, bq, bk)
    spad_q, spad_k = nq * bq, nk * bk
    dout_p = _pad_seq(dout, spad_q - sq)
    out_p = _pad_seq(out, spad_q - sq)
    lse_p = tf.pad(lse, (0, spad_q - sq), value=torch.inf)
    qg = qp_.reshape(b, spad_q, hkv, g, dh).to(torch.float32)
    dog = dout_p.reshape(b, spad_q, hkv, g, dv).to(torch.float32)
    og = out_p.reshape(b, spad_q, hkv, g, dv).to(torch.float32)
    dsum = (dog * og).sum(-1).permute(0, 2, 3, 1)                   # (B,Hkv,G,Sq)
    kg = kp_.reshape(b, nk, bk, hkv, dh).to(torch.float32)
    vg = vp_.reshape(b, nk, bk, hkv, dv).to(torch.float32)
    q_pos = q_offset + torch.arange(spad_q, device=dev)
    k_pos = torch.arange(spad_k, device=dev).reshape(nk, bk)
    dq = torch.zeros((b, spad_q, hkv, g, dh), dtype=torch.float32, device=dev)
    dks, dvs = [], []
    for kj in range(nk):
        kb, vb, kp = kg[:, kj], vg[:, kj], k_pos[kj]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kb) * scale
        if causal:
            s = torch.where(q_pos[:, None] >= kp[None, :], s, -torch.inf)
        s = torch.where(kp < sk, s, -torch.inf)
        p = torch.exp(s - lse_p[..., None])                         # (B,Hkv,G,Sq,K)
        dvs.append(torch.einsum("bhgqk,bqhgv->bkhv", p, dog))
        dp = torch.einsum("bqhgv,bkhv->bhgqk", dog, vb)
        ds = p * (dp - dsum[..., None])
        dq = dq + torch.einsum("bhgqk,bkhd->bqhgd", ds, kb) * scale
        dks.append(torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale)
    dq = dq.reshape(b, spad_q, h, dh)[:, :sq].to(q.dtype)
    dk = torch.cat(dks, dim=1)[:, :sk].to(k.dtype)
    dv_ = torch.cat(dvs, dim=1)[:, :sk].to(v.dtype)
    return dq, dk, dv_


class _FlashFn(torch.autograd.Function):
    """The reference's ``custom_vjp``: the forward keeps (q, k, v, out, lse),
    the backward is ``_flash_bwd``'s recompute, never autograd through the
    block loop."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, block_q, block_k):
        out, lse = _flash_fwd_impl(q, k, v, causal, q_offset, block_q, block_k, None)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (causal, q_offset, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = _flash_bwd(*ctx.cfg, ctx.saved_tensors, dout)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    block_q: int = 512, block_k: int = 1024,
                    kv_len: Optional[int] = None):
    """Memory-linear attention with GQA and a flash (recompute) backward.

    q: (B, Sq, H, Dh); k, v: (B, Sk, Hkv, Dv-capable); H % Hkv == 0.
    ``q_offset``: absolute position of q[0].  ``kv_len``: valid key length
    (decode over a cache; that path is not differentiated).
    Returns (B, Sq, H, Dv).
    """
    if is_dtensor(q) or is_dtensor(k):
        return _on_local_heads(lambda ql, kl, vl: flash_attention(
            ql, kl, vl, causal=causal, q_offset=q_offset, block_q=block_q, block_k=block_k,
            kv_len=kv_len), q, k, v)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if kv_len is not None or not grad:
        return _flash_fwd_impl(q, k, v, causal, q_offset, block_q, block_k, kv_len)[0]
    return _FlashFn.apply(q, k, v, causal, q_offset, block_q, block_k)


def _on_local_heads(fn, q, k, v):
    """``fn(q, k, v)``, an attention over ``(B, S, H, D)`` heads with GQA, on
    DTensors through ``local_map``: the batch over the data group, the
    heads over ``model`` where they split — q and kv heads both, or q heads
    only when the kv heads divide ``model`` (each rank's q heads then share
    one kv head, which the rank takes from the whole k / v) — else whole on
    every rank.  The flash path's custom autograd runs on the local
    shards; a rank's gradient of the kv head it took is a pending sum
    (``Partial``) over ``model``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = (q if is_dtensor(q) else k).device_mesh
    q, k, v = (x if is_dtensor(x) else DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim)
               for x in (q, k, v))
    m = axis_sizes(mesh).get("model", 1)
    h, hkv = q.shape[2], k.shape[2]
    g = h // hkv
    q_heads = "model" if h % m == 0 and (hkv % m == 0 or m % hkv == 0) else None
    kv_heads = "model" if q_heads and hkv % m == 0 else None
    dp = dp_entry(mesh, q.shape[0])
    q_pl = to_placements((dp, None, q_heads, None), mesh)
    kv_pl = to_placements((dp, None, kv_heads, None), mesh)

    def local(ql, kl, vl):
        if q_heads and not kv_heads and kl.shape[2] > 1:
            i = mesh.get_local_rank("model") * ql.shape[2] // g
            kl, vl = kl[:, :, i:i + 1], vl[:, :, i:i + 1]
        return fn(ql, kl, vl)

    kv_grad = [Partial() if q_heads and not kv_heads and name == "model" else p
               for name, p in zip(mesh.mesh_dim_names, kv_pl)]
    q_pl, kv_pl = list(q_pl), list(kv_pl)
    return local_map(local, out_placements=q_pl, in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


# ---------------------------------------------------------------- attention layer


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    qk_norm: bool = False
    rope_theta: float = 1e4
    causal: bool = True


def attention_init(generator, cfg: AttnConfig, param_dtype, device="cuda"):
    p = {
        "wq": dense_init(generator, cfg.d_model, cfg.n_heads * cfg.d_head, param_dtype,
                         device=device),
        "wk": dense_init(generator, cfg.d_model, cfg.n_kv_heads * cfg.d_head, param_dtype,
                         device=device),
        "wv": dense_init(generator, cfg.d_model, cfg.n_kv_heads * cfg.d_head, param_dtype,
                         device=device),
        "wo": dense_init(generator, cfg.n_heads * cfg.d_head, cfg.d_model, param_dtype,
                         device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(cfg.d_head, param_dtype, device)
        p["k_norm"] = rmsnorm_init(cfg.d_head, param_dtype, device)
    return p


def make_cache(batch, max_len, n_kv_heads, d_head, dtype, device="cuda"):
    return {
        "k": torch.zeros((batch, max_len, n_kv_heads, d_head), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, n_kv_heads, d_head), dtype=dtype, device=device),
    }


def attention(params, x, cfg: AttnConfig, compute_dtype, *, positions=None,
              cache=None, cache_index=None, kv_x=None):
    """Self- or cross-attention.

    Training/prefill: ``cache=None`` → flash attention over x (causal per cfg).
    Prefill into a cache: pass ``cache``; decode: pass ``cache`` and an int
    ``cache_index``, x is (B, 1, D).  Both return (out, cache): the new
    keys and values are written into ``cache``'s tensors in place (the
    reference returns an updated copy; the function is the same).
    Cross-attention: pass ``kv_x`` (B, Skv, D) (encoder memory;
    non-causal, no rope on cross keys).
    """
    b, s, _ = x.shape
    src = x if kv_x is None else kv_x
    # on DTensors the reference's pinning: the flat head dim over ``model``
    # only where the head count splits over it
    qm = "model" if model_divides(cfg.n_heads) else None
    km = "model" if model_divides(cfg.n_kv_heads) else None
    # (and whole where it does not: a split head dim cannot be unflattened)
    q = _flat_heads(constrain(dense(params["wq"], x, compute_dtype), "dp", None, qm), qm) \
        .reshape(b, s, cfg.n_heads, cfg.d_head)
    k = _flat_heads(constrain(dense(params["wk"], src, compute_dtype), "dp", None, km), km) \
        .reshape(b, src.shape[1], cfg.n_kv_heads, cfg.d_head)
    v = _flat_heads(constrain(dense(params["wv"], src, compute_dtype), "dp", None, km), km) \
        .reshape(b, src.shape[1], cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    if kv_x is None:  # rope only applies to self-attention
        q = rope(q, positions, cfg.rope_theta)
        if cache is not None and cache_index is not None:
            k = rope(k, positions, cfg.rope_theta)
        else:
            k = rope(k, torch.arange(src.shape[1], device=x.device)[None, :], cfg.rope_theta)

    if cache is not None:
        start = 0 if cache_index is None else cache_index
        cache_write(cache["k"], k, start)
        cache_write(cache["v"], v, start)
        if cache_index is not None:  # decode: attend over the cache's first index + s rows
            out = _decode_attend(q, cache["k"], cache["v"], cache_index + s, compute_dtype)
        else:  # prefill into the cache
            out = flash_attention(q, k, v, causal=cfg.causal)
        out = constrain(out.reshape(b, s, cfg.n_heads * cfg.d_head), "dp", None, "model")
        return constrain_batch(dense(params["wo"], out, compute_dtype)), cache

    out = flash_attention(q, k, v, causal=cfg.causal and kv_x is None)
    out = constrain(out.reshape(b, s, cfg.n_heads * cfg.d_head), "dp", None, "model")
    return constrain_batch(dense(params["wo"], out, compute_dtype))


def _flat_heads(x, split):
    """``x`` (B, S, H·D) whole along the flat head dim unless ``split``."""
    return x if split else replicate_dim(x, 2)


def cache_write(cache_t, new, start: int) -> None:
    """``cache_t[:, start:start + S] = new`` in place, ``new`` (B, S, ...)
    cast to the cache's dtype.  A DTensor cache is written through its
    local shard (an in-place write has no sharding strategy): ``new``
    takes the cache's layout, whole along the sequence, and each rank
    writes the rows of its own sequence range."""
    if not is_dtensor(cache_t):
        cache_t[:, start:start + new.shape[1]] = new.to(cache_t.dtype)
        return
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    mesh, pl = cache_t.device_mesh, cache_t.placements
    if not is_dtensor(new):
        new = DTensor.from_local(new, mesh, (Replicate(),) * mesh.ndim)
    whole_seq = tuple(Replicate() if getattr(p, "dim", None) == 1 else p for p in pl)
    new_l = new.redistribute(mesh, whole_seq).to_local()
    local = cache_t.to_local()
    _, off = compute_local_shape_and_global_offset(cache_t.shape, mesh, pl)
    lo, n = off[1], local.shape[1]
    a, e = max(start, lo), min(start + new.shape[1], lo + n)
    if a < e:
        local[:, a - lo:e - lo] = new_l[:, a - start:e - start].to(local.dtype)


def cross_kv(params, kv_x, cfg: AttnConfig, compute_dtype):
    """Precompute cross-attention K/V from encoder memory (cache once)."""
    b, skv, _ = kv_x.shape
    k = dense(params["wk"], kv_x, compute_dtype).reshape(b, skv, cfg.n_kv_heads, cfg.d_head)
    v = dense(params["wv"], kv_x, compute_dtype).reshape(b, skv, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        k = rmsnorm(params["k_norm"], k)
    return k, v


def attention_with_kv(params, x, k, v, cfg: AttnConfig, compute_dtype):
    """Cross-attention against precomputed K/V (decode path; non-causal)."""
    b, s, _ = x.shape
    q = dense(params["wq"], x, compute_dtype).reshape(b, s, cfg.n_heads, cfg.d_head)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q)
    out = _decode_attend(q, k, v, k.shape[1], compute_dtype)
    out = out.reshape(b, s, cfg.n_heads * cfg.d_head)
    return dense(params["wo"], out, compute_dtype)


def _decode_attend(q, k_cache, v_cache, kv_len, compute_dtype):
    """Single/few-token attention over a cache: O(S) scores, no S×S.  The
    scores and softmax in f32; the probabilities round to the compute
    dtype, and their product with v is in it.  A DTensor cache is attended
    shard by shard (``over_cache_shards``)."""
    if is_dtensor(k_cache):
        return over_cache_shards(
            lambda ql, kl, vl, key_offset, groups: _decode_attend_local(
                ql, kl, vl, kv_len, compute_dtype, key_offset, groups),
            q, k_cache, v_cache)
    return _decode_attend_local(q, k_cache, v_cache, kv_len, compute_dtype)


def _decode_attend_local(q, k_cache, v_cache, kv_len, compute_dtype, key_offset=0, groups=()):
    b, s, h, dh = q.shape
    hkv = k_cache.shape[2]
    g = h // hkv
    qg = q.reshape(b, s, hkv, g, dh).to(torch.float32)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                          k_cache.to(compute_dtype).to(torch.float32))
    scores = scores * (dh ** -0.5)
    kpos = key_offset + torch.arange(k_cache.shape[1], device=q.device)
    scores = torch.where(kpos < kv_len, scores, -torch.inf)
    out = split_softmax_product(
        scores, lambda p: torch.einsum("bhgqk,bkhd->bqhgd", p.to(compute_dtype),
                                       v_cache.to(compute_dtype)), groups)
    return out.reshape(b, s, h, dh)


def split_softmax_product(scores, product, groups=()):
    """``product(softmax(scores, -1))`` where ``product`` is linear in the
    probabilities.  With ``groups`` (``(mesh, mesh dim)`` pairs over whose
    ranks the key axis is split) each rank holds its keys' scores: the
    max, the denominator and the product are all-reduced over the groups
    (the partial reductions GSPMD makes of a softmax over a sharded
    axis)."""
    if not groups:
        return product(torch.softmax(scores, dim=-1))
    from torch.distributed import _functional_collectives as funcol
    m = scores.amax(dim=-1, keepdim=True)
    for group in groups:
        m = funcol.all_reduce(m, "max", group)
    p = torch.exp(scores - m)
    den = p.sum(dim=-1, keepdim=True)
    for group in groups:
        den = funcol.all_reduce(den, "sum", group)
    out = product(p / den)
    for group in groups:
        out = funcol.all_reduce(out, "sum", group)
    return out


def over_cache_shards(fn, q, *caches):
    """``fn(q, *caches, key_offset, groups)`` on the local shards of
    DTensor caches ``(B, T, ...)``: q (B, S, ...) takes the caches' batch
    layout and is whole otherwise, each rank attends over its own key range
    (the caches' dim 1, which starts at ``key_offset`` on this rank) and
    ``groups`` names the mesh dims that split it, for
    ``split_softmax_product``.  A cache split on a dim past the keys is
    gathered along it first.  Returns q's layout."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    mesh = caches[0].device_mesh
    pl = tuple(p if getattr(p, "dim", None) in (0, 1) else Replicate()
               for p in caches[0].placements)
    caches = [c.redistribute(mesh, pl) if tuple(c.placements) != pl else c for c in caches]
    q_pl = tuple(p if getattr(p, "dim", None) == 0 else Replicate() for p in pl)
    if not is_dtensor(q):
        q = DTensor.from_local(q, mesh, (Replicate(),) * mesh.ndim)
    q = q.redistribute(mesh, q_pl)
    _, off = compute_local_shape_and_global_offset(caches[0].shape, mesh, pl)
    groups = [(mesh, i) for i, p in enumerate(pl) if getattr(p, "dim", None) == 1]
    out = fn(q.to_local(), *(c.to_local() for c in caches), off[1], groups)
    return DTensor.from_local(out, mesh, q_pl, run_check=False)

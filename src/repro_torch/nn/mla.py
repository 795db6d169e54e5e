"""Multi-head Latent Attention (DeepSeek-V2) with the absorbed decode path:
the JAX package's ``nn/mla.py``, the same math on tensors.

Train / prefill: materialise per-head K/V from the KV latent and run the
flash loop (``nn.layers.flash_attention``, ``d_qk = d_nope + d_rope``,
``d_v`` its own width).

Decode: the *absorbed* form: ``W_kb`` folded into the query and ``W_vb``
applied after the attention, which attends directly over the cached
``(T, kv_lora + d_rope)`` latent; the per-head K/V is never built.  The
scores are f32 products of the (exactly widened) compute-dtype operands,
as the reference's ``preferred_element_type=float32`` einsums.

The cache is ``{"ckv": (B, T, kv_lora), "krope": (B, T, d_rope)}`` in the
compute dtype, written in place (prefill at offset 0, decode at
``cache_index``), as the port's dense attention writes its KV cache; the
reference returns an updated copy, the function is the same.  Its
``constrain`` calls are the reference's (the identity on plain tensors);
on DTensors the cache is written and attended through each rank's shard
(``layers.cache_write``, ``layers.over_cache_shards``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..dist.sharding import constrain, is_dtensor
from .layers import (cache_write, dense, dense_init, flash_attention, over_cache_shards, rmsnorm,
                     rmsnorm_init, rope, split_softmax_product)

__all__ = ["MLAConfig", "mla_init", "mla_apply", "mla_make_cache"]


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora: int = 1536
    kv_lora: int = 512
    d_nope: int = 128
    d_rope: int = 64
    d_v: int = 128
    rope_theta: float = 1e4


def mla_init(generator, cfg: MLAConfig, param_dtype, device="cuda"):
    """The reference's tree, the projections drawn in its key order (wq_a,
    wq_b, wkv_a, wk_b, wv_b, wo); the norms are ones."""
    h = cfg.n_heads

    def w(d_in, d_out):
        return dense_init(generator, d_in, d_out, param_dtype, device=device)

    wq_a = w(cfg.d_model, cfg.q_lora)
    wq_b = w(cfg.q_lora, h * (cfg.d_nope + cfg.d_rope))
    wkv_a = w(cfg.d_model, cfg.kv_lora + cfg.d_rope)
    wk_b = w(cfg.kv_lora, h * cfg.d_nope)
    wv_b = w(cfg.kv_lora, h * cfg.d_v)
    return {
        "wq_a": wq_a, "q_norm": rmsnorm_init(cfg.q_lora, param_dtype, device),
        "wq_b": wq_b, "wkv_a": wkv_a,
        "kv_norm": rmsnorm_init(cfg.kv_lora, param_dtype, device),
        "wk_b": wk_b, "wv_b": wv_b, "wo": w(h * cfg.d_v, cfg.d_model),
    }


def mla_make_cache(batch, max_len, cfg: MLAConfig, dtype, device="cuda"):
    return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora), dtype=dtype, device=device),
            "krope": torch.zeros((batch, max_len, cfg.d_rope), dtype=dtype, device=device)}


def _project_q(params, x, cfg, compute_dtype, positions):
    b, s, _ = x.shape
    q = dense(params["wq_b"], rmsnorm(params["q_norm"], dense(params["wq_a"], x, compute_dtype)),
              compute_dtype).reshape(b, s, cfg.n_heads, cfg.d_nope + cfg.d_rope)
    q_nope, q_rope = q[..., : cfg.d_nope], q[..., cfg.d_nope:]
    return q_nope, rope(q_rope, positions, cfg.rope_theta)


def _latent(params, x, cfg, compute_dtype, positions):
    """The KV latent (rmsnormed) and the shared rope key, through a one-head
    view ``(B, S, 1, d_rope)`` for ``rope``."""
    kv = dense(params["wkv_a"], x, compute_dtype)
    ckv = rmsnorm(params["kv_norm"], kv[..., : cfg.kv_lora])
    krope = rope(kv[..., None, cfg.kv_lora:], positions, cfg.rope_theta)[..., 0, :]
    return ckv, krope


def _absorbed_decode(params, q_nope, q_rope, cache, cfg, compute_dtype, kv_len):
    b, s, h, _ = q_nope.shape
    wk_b = params["wk_b"]["w"].to(compute_dtype).reshape(cfg.kv_lora, h, cfg.d_nope)
    wv_b = params["wv_b"]["w"].to(compute_dtype).reshape(cfg.kv_lora, h, cfg.d_v)
    # q absorbed into latent space: (B, s, H, kv_lora)
    q_lat = torch.einsum("bshn,khn->bshk", q_nope, wk_b)
    q_both = torch.cat([q_lat.to(torch.float32), q_rope.to(torch.float32)], dim=-1) \
        if is_dtensor(cache["ckv"]) else None
    if q_both is not None:   # a DTensor cache: attended shard by shard
        o_lat = over_cache_shards(
            lambda ql, ckv, krope, key_offset, groups: _latent_attend(
                ql[..., :cfg.kv_lora], ql[..., cfg.kv_lora:], ckv, krope, cfg, compute_dtype,
                kv_len, key_offset, groups), q_both, cache["ckv"], cache["krope"])
    else:
        o_lat = _latent_attend(q_lat, q_rope, cache["ckv"], cache["krope"], cfg, compute_dtype,
                               kv_len)
    out = torch.einsum("bshk,khv->bshv", o_lat, wv_b)
    return dense(params["wo"], out.reshape(b, s, h * cfg.d_v), compute_dtype)


def _latent_attend(q_lat, q_rope, ckv, krope, cfg, compute_dtype, kv_len, key_offset=0,
                   groups=()):
    """The absorbed attention over the latent cache ``ckv`` / ``krope``
    (its keys from ``key_offset``; ``groups`` as
    ``layers.split_softmax_product``) → (B, s, H, kv_lora)."""
    ckv = ckv.to(compute_dtype)
    scores = (torch.einsum("bshk,btk->bhst", q_lat.to(torch.float32), ckv.to(torch.float32))
              + torch.einsum("bshr,btr->bhst", q_rope.to(torch.float32),
                             krope.to(compute_dtype).to(torch.float32)))
    scores = scores * ((cfg.d_nope + cfg.d_rope) ** -0.5)
    tpos = key_offset + torch.arange(ckv.shape[1], device=ckv.device)
    scores = torch.where(tpos < kv_len, scores, -torch.inf)
    return split_softmax_product(
        scores, lambda w: torch.einsum("bhst,btk->bshk", w.to(compute_dtype), ckv), groups)


def mla_apply(params, x, cfg: MLAConfig, compute_dtype, *, positions=None,
              cache=None, cache_index=None):
    """x: (B, S, D).  Training / prefill: ``cache=None`` → the output; a
    ``cache`` without ``cache_index`` → (output, cache), the latent written
    at offset 0.  Decode: ``cache`` and an int ``cache_index`` → (output,
    cache), the latent written at ``cache_index`` and attended over its
    first ``cache_index + S`` rows in the absorbed form."""
    b, s, _ = x.shape
    h = cfg.n_heads
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q_nope, q_rope = _project_q(params, x, cfg, compute_dtype, positions)
    ckv, krope = _latent(params, x, cfg, compute_dtype, positions)

    if cache is not None:
        start = 0 if cache_index is None else cache_index
        # prefill: the write takes the cache's (feature-split) layout
        cache_write(cache["ckv"], constrain(ckv, "dp", None, "model"), start)
        cache_write(cache["krope"], krope, start)
        if cache_index is not None:
            return _absorbed_decode(params, q_nope, q_rope, cache, cfg, compute_dtype,
                                    cache_index + s), cache

    # train / prefill: materialise per-head K/V, flash attend
    wk_b = params["wk_b"]["w"].to(compute_dtype).reshape(cfg.kv_lora, h, cfg.d_nope)
    wv_b = params["wv_b"]["w"].to(compute_dtype).reshape(cfg.kv_lora, h, cfg.d_v)
    # the per-head tensors are the memory hot spot (S·H·d ≫ S·kv_lora): on
    # DTensors their heads split over ``model``
    k_nope = constrain(torch.einsum("btk,khn->bthn", ckv, wk_b), "dp", None, "model", None)
    vv = constrain(torch.einsum("btk,khv->bthv", ckv, wv_b), "dp", None, "model", None)
    kk = torch.cat([k_nope, krope[:, :, None, :].expand(b, s, h, cfg.d_rope)], dim=-1)
    qq = torch.cat([q_nope, q_rope], dim=-1)
    kk = constrain(kk, "dp", None, "model", None)
    qq = constrain(qq, "dp", None, "model", None)
    out = flash_attention(qq, kk, vv, causal=True)
    out = dense(params["wo"], out.reshape(b, s, h * cfg.d_v), compute_dtype)
    return out if cache is None else (out, cache)

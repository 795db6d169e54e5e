"""Encoder–decoder backbone for seamless-m4t-large-v2 (audio → text): the
JAX package's ``models/encdec.py``.

The speech frontend is a stub, as in the reference: the inputs carry
precomputed frame embeddings ``(B, S_enc, d_model)``.  The backbone — a
full-attention encoder and a causal decoder with cross-attention — is
real and carries the 256k-row text vocabulary, the most
embedding-dominated table of all the archs (the paper's QR technique
applies to it through ``cfg.embedding``).

Layouts are the reference's: the encoder and decoder layers are stacked,
``(enc_layers, ...)`` and ``(dec_layers, ...)`` leaves filled in place by
``lm.stack_layers``, so ``repro_torch.convert.params_from_jax`` carries a
JAX tree over unchanged.  ``encode`` and the decoder stack loop over the
leading axis with one ``torch.utils.checkpoint`` per layer when
``cfg.remat`` is set (the reference's ``jax.checkpoint`` around its
``lax.scan`` body).

Training looks the vocabulary up through the plain ``embed.apply``;
serving (``encdec_prefill``, ``encdec_decode_step``) through
``lm.embed_serving``, one K1 launch per call on the card for a QR
mult/add pair.  The decode cache holds the decoder's self-attention KV,
written in place through per-layer views, and the cross-attention K/V,
computed once from the encoder memory at prefill: ``encdec_prefill``
returns them at the frames' length ``S_enc`` (not the allocated
``max_len // enc_ratio`` of ``encdec_make_cache``), as the reference
does.  The reference's ``constrain_batch`` calls stand where it has them
(the identity on plain tensors).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from ..core import EmbeddingSpec
from ..dist.sharding import constrain_batch
from ..nn.layers import (AttnConfig, attention, attention_init, attention_with_kv, cross_kv,
                         dense, dense_init, mlp, mlp_init, rmsnorm, rmsnorm_init)
from .lm import _dtype, chunked_xent, embed_module, embed_serving, embed_tokens, stack_layers, \
    unstack

__all__ = ["EncDecConfig", "encdec_init", "encdec_loss_fn", "encode", "encdec_forward",
           "encdec_make_cache", "encdec_prefill", "encdec_decode_step"]


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str = "seamless"
    vocab: int = 256206
    d_model: int = 1024
    enc_layers: int = 24
    dec_layers: int = 24
    n_heads: int = 16
    n_kv_heads: int = 16
    d_head: int = 64
    d_ff: int = 8192
    ffn_kind: str = "gelu"
    rope_theta: float = 1e4
    enc_ratio: int = 4           # S_enc = seq_len // enc_ratio
    embedding: EmbeddingSpec = EmbeddingSpec()
    param_dtype: Any = "bfloat16"
    compute_dtype: Any = "bfloat16"
    xent_chunk: int = 512
    remat: bool = True

    @property
    def pdtype(self) -> torch.dtype:
        return _dtype(self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return _dtype(self.compute_dtype)

    def attn_cfg(self, causal: bool) -> AttnConfig:
        return AttnConfig(d_model=self.d_model, n_heads=self.n_heads,
                          n_kv_heads=self.n_kv_heads, d_head=self.d_head,
                          rope_theta=self.rope_theta, causal=causal)


# ---------------------------------------------------------------- init


def _enc_layer_init(generator, cfg: EncDecConfig, device):
    return {"norm1": rmsnorm_init(cfg.d_model, cfg.pdtype, device),
            "attn": attention_init(generator, cfg.attn_cfg(False), cfg.pdtype, device),
            "norm2": rmsnorm_init(cfg.d_model, cfg.pdtype, device),
            "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.pdtype, cfg.ffn_kind, device)}


def _dec_layer_init(generator, cfg: EncDecConfig, device):
    return {"norm1": rmsnorm_init(cfg.d_model, cfg.pdtype, device),
            "self_attn": attention_init(generator, cfg.attn_cfg(True), cfg.pdtype, device),
            "norm_x": rmsnorm_init(cfg.d_model, cfg.pdtype, device),
            "cross_attn": attention_init(generator, cfg.attn_cfg(False), cfg.pdtype, device),
            "norm2": rmsnorm_init(cfg.d_model, cfg.pdtype, device),
            "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.pdtype, cfg.ffn_kind, device)}


def encdec_init(generator, cfg: EncDecConfig, device="cuda"):
    """The reference's tree, drawn from ``generator`` on ``device`` in its
    key order: the embedding, the frontend projection, the encoder layers
    (into stacked leaves), the decoder layers, the LM head."""
    embed = embed_module(cfg).init(generator, device)
    frontend = dense_init(generator, cfg.d_model, cfg.d_model, cfg.pdtype, device=device)
    enc = stack_layers(lambda: _enc_layer_init(generator, cfg, device), (cfg.enc_layers,), device)
    dec = stack_layers(lambda: _dec_layer_init(generator, cfg, device), (cfg.dec_layers,), device)
    return {"embed": embed, "frontend_proj": frontend,
            "encoder": enc, "enc_norm": rmsnorm_init(cfg.d_model, cfg.pdtype, device),
            "decoder": dec, "final_norm": rmsnorm_init(cfg.d_model, cfg.pdtype, device),
            "lm_head": dense_init(generator, cfg.d_model, cfg.vocab, cfg.pdtype, device=device)}


# ---------------------------------------------------------------- forward


def _stack(layer_fn, stacked, h, cfg, *args):
    """``h`` through each layer of ``stacked``, one checkpoint per layer
    under grad when ``cfg.remat`` is set."""
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in unstack(stacked):
        h = checkpoint(layer_fn, lp, h, cfg, *args, use_reentrant=False) if remat \
            else layer_fn(lp, h, cfg, *args)
    return h


def _enc_layer(lp, h, cfg: EncDecConfig):
    h = h + attention(lp["attn"], rmsnorm(lp["norm1"], h), cfg.attn_cfg(False), cfg.cdtype)
    return constrain_batch(h + mlp(lp["mlp"], rmsnorm(lp["norm2"], h), cfg.cdtype,
                                   cfg.ffn_kind))


def _dec_layer(lp, h, cfg: EncDecConfig, memory):
    h = h + attention(lp["self_attn"], rmsnorm(lp["norm1"], h), cfg.attn_cfg(True), cfg.cdtype)
    h = h + attention(lp["cross_attn"], rmsnorm(lp["norm_x"], h), cfg.attn_cfg(False),
                      cfg.cdtype, kv_x=memory)
    return constrain_batch(h + mlp(lp["mlp"], rmsnorm(lp["norm2"], h), cfg.cdtype,
                                   cfg.ffn_kind))


def encode(params, frames, cfg: EncDecConfig):
    """frames: (B, S_enc, d_model) stub embeddings → encoder memory."""
    h = constrain_batch(dense(params["frontend_proj"], frames.to(cfg.cdtype), cfg.cdtype))
    return rmsnorm(params["enc_norm"], _stack(_enc_layer, params["encoder"], h, cfg))


def encdec_forward(params, h, memory, cfg: EncDecConfig):
    """The decoder stack on embedded tokens ``h`` (B, S, D) against the
    encoder ``memory``: the final-normed hidden states (the reference's
    ``_decode_stack``)."""
    return rmsnorm(params["final_norm"], _stack(_dec_layer, params["decoder"], h, cfg, memory))


def encdec_loss_fn(params, batch, cfg: EncDecConfig):
    """batch: frames (B,Se,D), tokens (B,S), labels (B,S), mask (B,S)."""
    memory = encode(params, batch["frames"], cfg)
    h = encdec_forward(params, embed_tokens(params, batch["tokens"], cfg), memory, cfg)
    loss = chunked_xent(h, batch["labels"], batch["mask"], params["lm_head"]["w"],
                        cfg.xent_chunk)
    return loss, {"xent": loss}


# ---------------------------------------------------------------- serving


def encdec_make_cache(cfg: EncDecConfig, batch: int, max_len: int, device="cuda"):
    """The decoder's self-attention KV ``(dec_layers, batch, max_len, Hkv,
    Dh)`` and a zero cross K/V ``(dec_layers, batch, max(1, max_len //
    enc_ratio), Hkv, Dh)`` (one tensor under both keys, as the reference's
    one array), in the compute dtype."""
    kv = (cfg.dec_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    cross = torch.zeros((cfg.dec_layers, batch, max(1, max_len // cfg.enc_ratio),
                         cfg.n_kv_heads, cfg.d_head), dtype=cfg.cdtype, device=device)
    return {"self": {"k": torch.zeros(kv, dtype=cfg.cdtype, device=device),
                     "v": torch.zeros(kv, dtype=cfg.cdtype, device=device)},
            "cross_k": cross, "cross_v": cross}


def _serve_layer(lp, h, cfg: EncDecConfig, self_cache, ck, cv, positions, cache_index):
    attn_out, _ = attention(lp["self_attn"], rmsnorm(lp["norm1"], h), cfg.attn_cfg(True),
                            cfg.cdtype, positions=positions, cache=self_cache,
                            cache_index=cache_index)
    h = h + attn_out
    h = h + attention_with_kv(lp["cross_attn"], rmsnorm(lp["norm_x"], h), ck, cv,
                              cfg.attn_cfg(False), cfg.cdtype)
    return h + mlp(lp["mlp"], rmsnorm(lp["norm2"], h), cfg.cdtype, cfg.ffn_kind)


def _prefill_hidden(params, h, memory, self_cache, cfg: EncDecConfig):
    """The decoder stack over a prompt's embedded tokens ``h`` as prefill
    runs it: each layer's cross K/V computed from ``memory``, its
    self-attention KV written into ``self_cache`` in place.  Returns the
    final-normed hidden states of every position and the cross K/V
    stacks ``(dec_layers, B, S_enc, Hkv, Dh)``."""
    cks, cvs = [], []
    for i, lp in enumerate(unstack(params["decoder"])):
        ck, cv = cross_kv(lp["cross_attn"], memory, cfg.attn_cfg(False), cfg.cdtype)
        h = _serve_layer(lp, h, cfg, {k: v[i] for k, v in self_cache.items()}, ck, cv, None,
                         None)
        cks.append(ck)
        cvs.append(cv)
    return rmsnorm(params["final_norm"], h), torch.stack(cks), torch.stack(cvs)


def encdec_prefill(params, frames, tokens, cache, cfg: EncDecConfig):
    """Encode the frames, compute each layer's cross K/V from the memory,
    and fill the decoder's self-attention cache from the prompt; returns
    (last-position logits (B, 1, V) f32, the cache: ``self`` written in
    place, ``cross_k`` / ``cross_v`` new ``(dec_layers, B, S_enc, Hkv,
    Dh)`` tensors)."""
    memory = encode(params, frames, cfg)
    h, cross_k, cross_v = _prefill_hidden(params, embed_serving(params, tokens, cfg), memory,
                                          cache["self"], cfg)
    logits = dense(params["lm_head"], h[:, -1:], cfg.cdtype).to(torch.float32)
    return logits, {"self": cache["self"], "cross_k": cross_k, "cross_v": cross_v}


def encdec_decode_step(params, tokens, pos: int, cache, cfg: EncDecConfig):
    """One decode step.  tokens: (B, 1); pos: the int index into the
    self-attention cache, which is written in place."""
    h = embed_serving(params, tokens, cfg)
    positions = torch.full((tokens.shape[0], 1), pos, device=tokens.device)
    for i, lp in enumerate(unstack(params["decoder"])):
        self_cache = {k: v[i] for k, v in cache["self"].items()}
        h = _serve_layer(lp, h, cfg, self_cache, cache["cross_k"][i], cache["cross_v"][i],
                         positions, pos)
    h = rmsnorm(params["final_norm"], h)
    return dense(params["lm_head"], h, cfg.cdtype).to(torch.float32), cache

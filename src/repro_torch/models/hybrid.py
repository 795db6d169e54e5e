"""SSM and hybrid-SSM language models, mamba2-370m and zamba2-1.2b: the JAX
package's ``models/hybrid.py``.

``MambaLM``: a pure Mamba2 stack (attention-free; with the hybrid, the
only archs the reference admits to the long_500k decode shape, since
their "KV cache" is an O(1) (H, N, P) state plus a (d_conv−1)-deep conv
window per layer).

``HybridLM`` (Zamba2-style): a Mamba2 backbone with a *shared*
transformer block (one set of attention + MLP weights) applied after
every ``block_len`` Mamba layers.  Structure: ``n_blocks`` ×
[``block_len`` Mamba layers → the shared block] + ``n_tail`` trailing
Mamba layers.  The shared weights' gradient sums over their
``n_blocks`` applications; their KV cache has one entry per application,
``(n_blocks, B, max_len, Hkv, Dh)``.

Layouts are the reference's: the Mamba layers are stacked, ``(n_layers,
...)`` leaves for MambaLM, ``(n_blocks, block_len, ...)`` and
``(n_tail, ...)`` for the hybrid, so ``repro_torch.convert.params_from_jax``
carries a JAX tree over unchanged.  Training checkpoints what the
reference does: each Mamba layer of MambaLM, each whole block (its Mamba
layers and the shared attention and MLP) of the hybrid, whose tail is
not checkpointed.

The vocabulary is ``models/lm.py``'s: training looks it up through the
plain ``embed.apply``; serving (``*_prefill``, ``*_decode_step``)
through ``lm.embed_serving``, one K1 launch per call on the card for a
QR mult/add pair.  Prefill and decode write the caches in place, through
per-layer views of the stacked tensors (the reference returns updated
copies; the function is the same).  The reference's ``constrain_batch``
calls stand where it has them (the identity on plain tensors).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from ..core import EmbeddingSpec
from ..dist.sharding import constrain_batch
from ..nn.layers import (AttnConfig, attention, attention_init, dense, dense_init, make_cache,
                         mlp, mlp_init, rmsnorm, rmsnorm_init)
from ..nn.ssm import SSMConfig, ssm_apply, ssm_decode, ssm_init, ssm_make_cache
from .lm import (_dtype, chunked_xent, embed_module, embed_serving, embed_tokens, stack_layers,
                 unstack)

__all__ = ["MambaLMConfig", "HybridLMConfig", "mamba_init", "mamba_forward", "mamba_loss_fn",
           "mamba_make_cache", "mamba_prefill", "mamba_decode_step", "hybrid_init",
           "hybrid_forward", "hybrid_loss_fn", "hybrid_make_cache", "hybrid_prefill",
           "hybrid_decode_step"]


# ---------------------------------------------------------------- shared pieces


def _mamba_layer_init(generator, d_model, ssm_cfg: SSMConfig, pdtype, device):
    return {"norm": rmsnorm_init(d_model, pdtype, device),
            "ssm": ssm_init(generator, ssm_cfg, pdtype, device)}


def _mamba_layer(lp, h, cfg):
    return constrain_batch(h + ssm_apply(lp["ssm"], rmsnorm(lp["norm"], h), cfg.ssm, cfg.cdtype))


def _prefill_layer(lp, h, cache_l, cfg):
    """One Mamba layer over a prompt, its final state and conv window
    written into the layer's cache views."""
    out, st = ssm_apply(lp["ssm"], rmsnorm(lp["norm"], h), cfg.ssm, cfg.cdtype,
                        return_state=True)
    cache_l["ssm"].copy_(st["ssm"])
    cache_l["conv"].copy_(st["conv"])
    return h + out


def _decode_layer(lp, h, cache_l, cfg):
    return h + ssm_decode(lp["ssm"], rmsnorm(lp["norm"], h), cfg.ssm, cfg.cdtype, cache_l)[0]


def _views(cache, *index):
    return {k: v[index] for k, v in cache.items()}


def _stacked_cache(one, lead, device):
    return {k: torch.zeros(tuple(lead) + tuple(v.shape), dtype=v.dtype, device=device)
            for k, v in one.items()}


def _head(params, h, cfg):
    return dense(params["lm_head"], h, cfg.cdtype).to(torch.float32)


def _loss(h, batch, params, cfg):
    loss = chunked_xent(h, batch["labels"], batch["mask"], params["lm_head"]["w"],
                        cfg.xent_chunk)
    return loss, {"xent": loss}


def _lm_init(generator, cfg, device, body):
    """The reference's tree order: the embedding, ``body()`` (the layers),
    then the final norm and the LM head."""
    embed = embed_module(cfg).init(generator, device)
    out = {"embed": embed, **body()}
    out["final_norm"] = rmsnorm_init(cfg.d_model, cfg.pdtype, device)
    out["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab, cfg.pdtype, device=device)
    return out


# ---------------------------------------------------------------- MambaLM


@dataclasses.dataclass(frozen=True)
class MambaLMConfig:
    name: str = "mamba2"
    vocab: int = 50280
    d_model: int = 1024
    n_layers: int = 48
    ssm: SSMConfig = SSMConfig(d_model=1024, d_state=128)
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


def mamba_init(generator, cfg: MambaLMConfig, device="cuda"):
    """The reference's tree drawn from ``generator`` on ``device``: the
    embedding, the layers one by one into ``(n_layers, ...)`` leaves, the
    final norm, the LM head."""
    def layers():
        return {"layers": stack_layers(
            lambda: _mamba_layer_init(generator, cfg.d_model, cfg.ssm, cfg.pdtype, device),
            (cfg.n_layers,), device)}

    return _lm_init(generator, cfg, device, layers)


def mamba_forward(params, h, cfg: MambaLMConfig):
    """The layer stack on embedded inputs ``h`` (B, S, D), one checkpoint
    per layer when ``cfg.remat`` and gradients are on; returns the
    final-normed hidden states."""
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in unstack(params["layers"]):
        h = checkpoint(_mamba_layer, lp, h, cfg, use_reentrant=False) if remat \
            else _mamba_layer(lp, h, cfg)
    return rmsnorm(params["final_norm"], h)


def mamba_loss_fn(params, batch, cfg: MambaLMConfig):
    """batch: tokens (B,S) int32, labels (B,S) int32, mask (B,S) f32."""
    return _loss(mamba_forward(params, embed_tokens(params, batch["tokens"], cfg), cfg),
                 batch, params, cfg)


def mamba_make_cache(cfg: MambaLMConfig, batch: int, max_len: int = 0, device="cuda"):
    """Per-layer SSM caches stacked ``(n_layers, ...)``: the f32 state and
    the conv window in the compute dtype.  ``max_len`` is ignored: the
    cache is O(1) in the length."""
    del max_len
    return _stacked_cache(ssm_make_cache(batch, cfg.ssm, cfg.cdtype, "meta"),
                          (cfg.n_layers,), device)


def mamba_prefill(params, tokens, cache, cfg: MambaLMConfig):
    """Fill the cache from a prompt of at least ``d_conv − 1`` tokens;
    returns (last-position logits (B, 1, V) f32, cache)."""
    h = embed_serving(params, tokens, cfg)
    for i, lp in enumerate(unstack(params["layers"])):
        h = _prefill_layer(lp, h, _views(cache, i), cfg)
    return _head(params, rmsnorm(params["final_norm"], h)[:, -1:], cfg), cache


def mamba_decode_step(params, tokens, pos: int, cache, cfg: MambaLMConfig):
    """One decode step.  tokens: (B, 1); ``pos`` is unused (the state is
    position-free)."""
    del pos
    h = embed_serving(params, tokens, cfg)
    for i, lp in enumerate(unstack(params["layers"])):
        h = _decode_layer(lp, h, _views(cache, i), cfg)
    return _head(params, rmsnorm(params["final_norm"], h), cfg), cache


# ---------------------------------------------------------------- HybridLM


@dataclasses.dataclass(frozen=True)
class HybridLMConfig:
    name: str = "zamba2"
    vocab: int = 32000
    d_model: int = 2048
    n_blocks: int = 6
    block_len: int = 6
    n_tail: int = 2          # n_mamba = n_blocks*block_len + n_tail = 38
    ssm: SSMConfig = SSMConfig(d_model=2048, d_state=64)
    n_heads: int = 32
    n_kv_heads: int = 32
    d_head: int = 64
    d_ff: int = 8192
    rope_theta: float = 1e4
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

    def attn_cfg(self) -> AttnConfig:
        return AttnConfig(d_model=self.d_model, n_heads=self.n_heads,
                          n_kv_heads=self.n_kv_heads, d_head=self.d_head,
                          rope_theta=self.rope_theta)


def hybrid_init(generator, cfg: HybridLMConfig, device="cuda"):
    """The reference's tree drawn from ``generator`` on ``device``: the
    embedding, the blocks' Mamba layers one by one into ``(n_blocks,
    block_len, ...)`` leaves, the tail's into ``(n_tail, ...)``, the shared
    block (attention, then MLP), the final norm, the LM head."""
    def body():
        def layer():
            return _mamba_layer_init(generator, cfg.d_model, cfg.ssm, cfg.pdtype, device)

        blocks = stack_layers(layer, (cfg.n_blocks, cfg.block_len), device)
        tail = stack_layers(layer, (cfg.n_tail,), device)
        attn = attention_init(generator, cfg.attn_cfg(), cfg.pdtype, device)
        shared = {"norm1": rmsnorm_init(cfg.d_model, cfg.pdtype, device), "attn": attn,
                  "norm2": rmsnorm_init(cfg.d_model, cfg.pdtype, device),
                  "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.pdtype, device=device)}
        return {"blocks": blocks, "tail": tail, "shared": shared}

    return _lm_init(generator, cfg, device, body)


def _shared_block(shared, h, cfg: HybridLMConfig, **attn_kw):
    """The shared attention and MLP; with a ``cache`` in ``attn_kw`` the
    attention writes its keys and values there."""
    attn = attention(shared["attn"], rmsnorm(shared["norm1"], h), cfg.attn_cfg(), cfg.cdtype,
                     **attn_kw)
    h = h + (attn[0] if "cache" in attn_kw else attn)
    return h + mlp(shared["mlp"], rmsnorm(shared["norm2"], h), cfg.cdtype)


def _block(bp, h, shared, cfg: HybridLMConfig):
    for lp in unstack(bp):
        h = _mamba_layer(lp, h, cfg)
    return _shared_block(shared, h, cfg)


def hybrid_forward(params, h, cfg: HybridLMConfig):
    """The blocks, then the tail, on embedded inputs ``h`` (B, S, D), one
    checkpoint per whole block when ``cfg.remat`` and gradients are on;
    returns the final-normed hidden states."""
    remat = cfg.remat and torch.is_grad_enabled()
    shared = params["shared"]
    for bp in unstack(params["blocks"]):
        h = checkpoint(_block, bp, h, shared, cfg, use_reentrant=False) if remat \
            else _block(bp, h, shared, cfg)
    for lp in unstack(params["tail"]):
        h = _mamba_layer(lp, h, cfg)
    return rmsnorm(params["final_norm"], h)


def hybrid_loss_fn(params, batch, cfg: HybridLMConfig):
    return _loss(hybrid_forward(params, embed_tokens(params, batch["tokens"], cfg), cfg),
                 batch, params, cfg)


def hybrid_make_cache(cfg: HybridLMConfig, batch: int, max_len: int, device="cuda"):
    """The blocks' SSM caches ``(n_blocks, block_len, ...)``, the tail's
    ``(n_tail, ...)``, and one KV cache per application of the shared
    attention, ``(n_blocks, batch, max_len, Hkv, Dh)`` in the compute
    dtype."""
    ssm_one = ssm_make_cache(batch, cfg.ssm, cfg.cdtype, "meta")
    kv_one = make_cache(batch, max_len, cfg.n_kv_heads, cfg.d_head, cfg.cdtype, "meta")
    return {"blocks": _stacked_cache(ssm_one, (cfg.n_blocks, cfg.block_len), device),
            "tail": _stacked_cache(ssm_one, (cfg.n_tail,), device),
            "kv": _stacked_cache(kv_one, (cfg.n_blocks,), device)}


def _hybrid_cached(params, h, cache, cfg: HybridLMConfig, layer_fn, **attn_kw):
    """The stack over the caches: ``layer_fn`` on each Mamba layer with its
    cache views, the shared block on each application's KV views."""
    shared = params["shared"]
    for bi, bp in enumerate(unstack(params["blocks"])):
        for li, lp in enumerate(unstack(bp)):
            h = layer_fn(lp, h, _views(cache["blocks"], bi, li), cfg)
        h = _shared_block(shared, h, cfg, cache=_views(cache["kv"], bi), **attn_kw)
    for i, lp in enumerate(unstack(params["tail"])):
        h = layer_fn(lp, h, _views(cache["tail"], i), cfg)
    return rmsnorm(params["final_norm"], h)


def hybrid_prefill(params, tokens, cache, cfg: HybridLMConfig):
    """Prefill: the chunked SSD forward capturing the states, and the
    shared attention's KV caches filled from 0; returns (last-position
    logits (B, 1, V) f32, cache)."""
    h = _hybrid_cached(params, embed_serving(params, tokens, cfg), cache, cfg, _prefill_layer)
    return _head(params, h[:, -1:], cfg), cache


def hybrid_decode_step(params, tokens, pos: int, cache, cfg: HybridLMConfig):
    """One decode step.  tokens: (B, 1); ``pos``: the int index into the KV
    caches."""
    positions = torch.full((tokens.shape[0], 1), pos, device=tokens.device)
    h = _hybrid_cached(params, embed_serving(params, tokens, cfg), cache, cfg, _decode_layer,
                       positions=positions, cache_index=pos)
    return _head(params, h, cfg), cache

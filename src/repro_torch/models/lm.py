"""Decoder-only LM covering the dense-GQA, MoE and MLA archs: the JAX
package's ``models/lm.py``.

One config surface (``LMConfig``) with the reference's fields and
defaults drives qwen3 / tinyllama / yi / granite (dense), arctic (MoE and
a parallel dense residual FFN) and deepseek-v2 (MLA and a MoE with
shared experts): the attention is ``nn.mla`` when ``cfg.mla`` is set,
else GQA; the FFN is ``nn.moe`` (plus ``dense_mlp`` under
``moe_parallel_dense`` and ``shared_mlp`` for ``n_shared_experts``) when
``cfg.moe`` is set, else the dense MLP.  The MoE layers' load-balance
losses sum over the layers into ``loss_fn``'s ``aux``; serving drops
them.  Layers are homogeneous and stacked: every layer leaf has a
leading ``n_layers`` axis, the reference's layout, so
``repro_torch.convert.params_from_jax`` carries a JAX LM tree over
unchanged.  ``forward_hidden`` loops over that axis, with one
``torch.utils.checkpoint`` per layer when ``cfg.remat`` is set (the
reference's ``jax.checkpoint`` around its ``lax.scan`` body).

The paper's technique enters through ``cfg.embedding`` (an
``EmbeddingSpec``): the token-vocabulary table, the model's one large
categorical embedding, is built by ``repro_torch.core.make_embedding``
and can be full, hashed or QR-compositional.  Serving (``prefill``,
``decode_step``) looks a QR mult/add vocabulary up through K1 (the
grouped one-hot kernel, ``ops.qr_lookup_grouped``: one launch, the id
split in the kernel) on a CUDA tensor and through its plain version on
the CPU; any other embedding takes the plain ``embed.apply`` on either
device.  Training (``loss_fn``) always takes the plain ``embed.apply``:
the kernels have no backward.  The LM head stays a dense projection; its
memory is addressed by chunked cross-entropy, never materialising
(B, S, V) logits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as tf
from torch.utils.checkpoint import checkpoint

from .. import tree
from ..core import CompositionalEmbedding, EmbeddingSpec, make_embedding
from ..core.partitions import QuotientPartition, RemainderPartition
from ..dist.sharding import constrain, constrain_batch, kernel_map, replicate_dim
from ..kernels import ops
from ..nn.layers import (AttnConfig, attention, attention_init, dense, dense_init,
                         make_cache, mlp, mlp_init, rmsnorm, rmsnorm_init)
from ..nn.mla import MLAConfig, mla_apply, mla_init, mla_make_cache
from ..nn.moe import MoEConfig, moe_apply, moe_init

__all__ = ["LMConfig", "init", "loss_fn", "forward_hidden", "make_decode_cache",
           "prefill", "decode_step", "chunked_xent", "embed_module", "embed_tokens",
           "embed_serving", "num_params", "stack_layers", "unstack"]

# The LM's f32 products stay true f32 on the card: no TF32 in float32
# matrix products (PyTorch's default, stated here so the LM does not
# depend on another module to set it).
torch.backends.cuda.matmul.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str = "lm"
    vocab: int = 32000
    d_model: int = 2048
    n_layers: int = 22
    n_heads: int = 32
    n_kv_heads: int = 4
    d_head: int = 64
    d_ff: int = 5632
    ffn_kind: str = "swiglu"
    qk_norm: bool = False
    rope_theta: float = 1e4
    moe: Optional[MoEConfig] = None
    moe_parallel_dense: bool = False     # Arctic: dense FFN residual ∥ MoE
    n_shared_experts: int = 0            # DeepSeek: always-on experts (d_ff each)
    mla: Optional[MLAConfig] = None
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
                          qk_norm=self.qk_norm, rope_theta=self.rope_theta)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ------------------------------------------------------------------ init


def _layer_init(generator, cfg: LMConfig, device):
    """One layer's tree, drawn in the reference's key order: the attention
    (MLA or GQA), then the MoE, its parallel dense FFN and its shared
    experts, or the dense MLP."""
    p = {"norm1": rmsnorm_init(cfg.d_model, cfg.pdtype, device),
         "norm2": rmsnorm_init(cfg.d_model, cfg.pdtype, device)}
    if cfg.mla is not None:
        p["attn"] = mla_init(generator, cfg.mla, cfg.pdtype, device)
    else:
        p["attn"] = attention_init(generator, cfg.attn_cfg(), cfg.pdtype, device)
    if cfg.moe is None:
        p["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.pdtype, cfg.ffn_kind, device)
        return p
    p["moe"] = moe_init(generator, cfg.moe, cfg.pdtype, device)
    if cfg.moe_parallel_dense:
        p["dense_mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.pdtype, cfg.ffn_kind,
                                  device)
    if cfg.n_shared_experts:
        p["shared_mlp"] = mlp_init(generator, cfg.d_model, cfg.n_shared_experts * cfg.moe.d_ff,
                                   cfg.pdtype, "swiglu", device)
    return p


def stack_layers(init_one, lead: tuple, device):
    """``init_one()``'s tree drawn ``prod(lead)`` times in order, each copied
    into its slice of leaves with the leading dimensions ``lead``, which are
    allocated once: the peak is the stack and one layer, not the stack
    twice.  ``lead`` is ``(n_layers,)`` for a stack, ``(n_blocks,
    block_len)`` for the hybrid's nested one."""
    layer = init_one()
    like = tree.tree_map(lambda t: 0, layer)
    stacked = [torch.empty(tuple(lead) + tuple(t.shape), dtype=t.dtype, device=device)
               for t in tree.leaves(layer)]
    for i in range(math.prod(lead)):
        if i:
            layer = init_one()
        for dst, src in zip(stacked, tree.leaves(layer)):
            dst.view((-1,) + tuple(src.shape))[i].copy_(src)
        layer = None
    return tree.unflatten(like, stacked)


def init(generator, cfg: LMConfig, device="cuda"):
    """The reference's tree, drawn from ``generator`` on ``device``: the
    embedding, then the layers one by one (into stacked ``(n_layers, ...)``
    leaves), then the LM head."""
    embed = embed_module(cfg).init(generator, device)
    layers = stack_layers(lambda: _layer_init(generator, cfg, device), (cfg.n_layers,), device)
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": rmsnorm_init(cfg.d_model, cfg.pdtype, device),
        "lm_head": dense_init(generator, cfg.d_model, cfg.vocab, cfg.pdtype, device=device),
    }


def num_params(params) -> int:
    return sum(leaf.numel() for leaf in tree.leaves(params))


def embed_module(cfg: LMConfig):
    return make_embedding(cfg.vocab, cfg.d_model, cfg.embedding, cfg.pdtype)


# ------------------------------------------------------------------ forward


def unstack(stacked) -> list:
    """One tree per index of the leaves' leading axis, each leaf a view of
    the stacked leaf (``unbind``: one backward that stacks the gradients)."""
    cols = [replicate_dim(leaf, 0).unbind(0) for leaf in tree.leaves(stacked)]
    return [tree.unflatten(stacked, [c[i] for c in cols]) for i in range(len(cols[0]))]


def _ffn(lp, h2, cfg: LMConfig):
    """Post-attention block: the dense MLP, or the MoE (+ the parallel dense
    FFN, + the shared experts); returns (out, the MoE's aux loss or None)."""
    if cfg.moe is None:
        return mlp(lp["mlp"], h2, cfg.cdtype, cfg.ffn_kind), None
    out, aux = moe_apply(lp["moe"], h2, cfg.moe, cfg.cdtype)
    if cfg.moe_parallel_dense:
        out = out + mlp(lp["dense_mlp"], h2, cfg.cdtype, cfg.ffn_kind)
    if cfg.n_shared_experts:
        out = out + mlp(lp["shared_mlp"], h2, cfg.cdtype, "swiglu")
    return out, aux


def _attend(lp, h1, cfg: LMConfig, positions, **cache):
    if cfg.mla is not None:
        return mla_apply(lp["attn"], h1, cfg.mla, cfg.cdtype, positions=positions, **cache)
    return attention(lp["attn"], h1, cfg.attn_cfg(), cfg.cdtype, positions=positions, **cache)


def _layer_apply(lp, h, cfg: LMConfig, positions):
    h = h + _attend(lp, rmsnorm(lp["norm1"], h), cfg, positions)
    out, aux = _ffn(lp, rmsnorm(lp["norm2"], h), cfg)
    return h + out, aux


def forward_hidden(params, h, cfg: LMConfig, positions=None):
    """Run the layer stack on already-embedded inputs ``h`` (B, S, D);
    returns the final-normed hidden states and the auxiliary loss summed
    over the layers (f32; 0 without MoE)."""
    if positions is None:
        positions = torch.arange(h.shape[1], device=h.device)[None, :]
    remat = cfg.remat and torch.is_grad_enabled()
    auxs = []
    for lp in unstack(params["layers"]):
        if remat:
            h, aux = checkpoint(_layer_apply, lp, h, cfg, positions, use_reentrant=False)
        else:
            h, aux = _layer_apply(lp, h, cfg, positions)
        h = constrain_batch(h)
        if aux is not None:
            auxs.append(aux)
    total = torch.stack(auxs).sum() if auxs else torch.zeros((), dtype=torch.float32,
                                                            device=h.device)
    return rmsnorm(params["final_norm"], h), total


def embed_tokens(params, tokens, cfg: LMConfig):
    """The plain lookup: ``embed.apply`` (differentiable), cast to the
    compute dtype."""
    module, emb = embed_module(cfg), params["embed"]
    # on DTensors the lookup (an indexed gather, whose backward is an
    # index_put) runs on each rank's tokens with the tables whole
    h = kernel_map(lambda ids, *leaves: module.apply(tree.unflatten(emb, list(leaves)), ids),
                   (tokens,), whole=tuple(tree.leaves(emb)))
    return constrain_batch(h.to(cfg.cdtype))


def _k1_pair(module) -> bool:
    """Whether K1 computes ``module.apply``: a QR pair (remainder, then
    quotient partition) combined with mult or add."""
    return (isinstance(module, CompositionalEmbedding) and module.op in ("mult", "add")
            and len(module.partitions) == 2
            and isinstance(module.partitions[0], RemainderPartition)
            and isinstance(module.partitions[1], QuotientPartition))


def embed_serving(params, tokens, cfg: LMConfig):
    """The serving lookup: a QR mult/add vocabulary through
    ``ops.qr_lookup_grouped`` (one K1 launch on a CUDA tensor, the id split
    in the kernel; its plain version on the CPU), bit-equal to
    ``embed_tokens`` for f32 and bf16 tables (the two rows combine in f32,
    exact for a product or sum of bf16 values, and round once); every
    other embedding through ``embed_tokens``."""
    module = embed_module(cfg)
    if _k1_pair(module):
        p = params["embed"]
        out = kernel_map(lambda ids, t0, t1: ops.qr_lookup_grouped(
            ids, [(t0, t1, 0, module.op, None)]), (tokens.reshape(-1, 1),),
            whole=(p["table_0"], p["table_1"]))
        if out is not None:
            return out.reshape(*tokens.shape, out.shape[-1]).to(cfg.cdtype)
    return embed_tokens(params, tokens, cfg)


# ------------------------------------------------------------------ loss


def chunked_xent(h, labels, mask, head_w, chunk: int):
    """Mean masked next-token xent without materialising (B, S, V) logits:
    the sequence in chunks of ``chunk`` (the last padded), each chunk's
    logits in f32, the gold logit gathered."""
    s = h.shape[1]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        h = tf.pad(h, (0, 0, 0, pad))
        labels = tf.pad(labels, (0, pad))
        mask = tf.pad(mask, (0, pad))
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(0, s + pad, chunk):
        hc, lc, mc = h[:, c:c + chunk], labels[:, c:c + chunk], mask[:, c:c + chunk]
        # on DTensors the vocabulary whole on each rank: the gold logit's
        # gather has no strategy over a split vocabulary
        logits = constrain((hc @ head_w.to(hc.dtype)).to(torch.float32), "dp", None, None)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc[..., None].long())[..., 0]
        total = total + ((logz - gold) * mc).sum()
    return total / torch.clamp(mask.sum(), min=1.0)


def loss_fn(params, batch, cfg: LMConfig):
    """batch: tokens (B,S) int32, labels (B,S) int32, mask (B,S) f32."""
    h = embed_tokens(params, batch["tokens"], cfg)
    h, aux = forward_hidden(params, h, cfg)
    loss = chunked_xent(h, batch["labels"], batch["mask"], params["lm_head"]["w"],
                        cfg.xent_chunk)
    return loss + aux, {"xent": loss, "aux": aux}


# ------------------------------------------------------------------ serving


def make_decode_cache(cfg: LMConfig, batch: int, max_len: int, device="cuda"):
    """Per-layer caches stacked ``(n_layers, ...)`` in the compute dtype:
    the KV cache ``(batch, max_len, Hkv, Dh)`` for GQA, the latent cache
    ``ckv`` ``(batch, max_len, kv_lora)`` and ``krope`` ``(batch, max_len,
    d_rope)`` for MLA."""
    if cfg.mla is not None:
        one = mla_make_cache(batch, max_len, cfg.mla, cfg.cdtype, "meta")
    else:
        one = make_cache(batch, max_len, cfg.n_kv_heads, cfg.d_head, cfg.cdtype, "meta")
    return {k: torch.zeros((cfg.n_layers,) + tuple(v.shape), dtype=v.dtype, device=device)
            for k, v in one.items()}


def _run_with_cache(params, h, cache, cfg: LMConfig, positions, cache_index):
    """The layer stack over a cache: each layer writes its rows of
    ``cache`` in place (per-layer views of the stacked tensors); the MoE's
    aux loss is dropped."""
    for i, lp in enumerate(unstack(params["layers"])):
        cache_l = {k: v[i] for k, v in cache.items()}
        attn_out, _ = _attend(lp, rmsnorm(lp["norm1"], h), cfg, positions, cache=cache_l,
                              cache_index=cache_index)
        h = h + attn_out
        h = h + _ffn(lp, rmsnorm(lp["norm2"], h), cfg)[0]
    return rmsnorm(params["final_norm"], h), cache


def prefill(params, tokens, cache, cfg: LMConfig):
    """Fill the cache from a prompt; returns (last-position logits (B, 1, V)
    f32, cache)."""
    h = embed_serving(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    h, cache = _run_with_cache(params, h, cache, cfg, positions, None)
    return dense(params["lm_head"], h[:, -1:], cfg.cdtype).to(torch.float32), cache


def decode_step(params, tokens, pos: int, cache, cfg: LMConfig):
    """One decode step.  tokens: (B, 1); pos: the int index into the cache."""
    h = embed_serving(params, tokens, cfg)
    positions = torch.full((tokens.shape[0], 1), pos, device=tokens.device)
    h, cache = _run_with_cache(params, h, cache, cfg, positions, pos)
    return dense(params["lm_head"], h, cfg.cdtype).to(torch.float32), cache

"""arctic-480b: 128-expert top-2 MoE with parallel dense residual FFN.
[hf:Snowflake/snowflake-arctic-base; hf]

The token vocabulary (32,000) is QR with ``num_collisions`` (c=4: an
8,000 x 7,168 remainder table and a 4 x 7,168 quotient table, ``mult``)
unless ``embedding`` says otherwise.
"""

from __future__ import annotations

from ..models.lm import LMConfig
from ..nn.moe import MoEConfig
from .common import embedding_spec, lm_api

ARCH, FAMILY, PARAMS_B = "arctic-480b", "moe", 476.0


def config(reduced: bool = False, embedding: str = "qr", num_collisions: int = 4) -> LMConfig:
    emb = embedding_spec(embedding, num_collisions)
    if reduced:
        return LMConfig(name=ARCH, vocab=512, d_model=64, n_layers=2, n_heads=4,
                        n_kv_heads=2, d_head=16, d_ff=128,
                        moe=MoEConfig(n_experts=8, top_k=2, d_model=64, d_ff=96,
                                      groups=8),
                        moe_parallel_dense=True, embedding=emb,
                        param_dtype="float32", compute_dtype="float32", xent_chunk=16)
    return LMConfig(name=ARCH, vocab=32000, d_model=7168, n_layers=35, n_heads=56,
                    n_kv_heads=8, d_head=128, d_ff=4864,
                    moe=MoEConfig(n_experts=128, top_k=2, d_model=7168, d_ff=4864,
                                  groups=256, capacity_factor=1.25),
                    moe_parallel_dense=True, embedding=emb)


def api(cfg, device="cuda"):
    return lm_api(cfg, PARAMS_B, accum=8, device=device)

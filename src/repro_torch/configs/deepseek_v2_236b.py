"""deepseek-v2-236b: MLA (kv_lora=512) + 160-expert top-6 MoE with 2 shared
experts. [arXiv:2405.04434; hf]

The token vocabulary (102,400) is QR with ``num_collisions`` (c=4: a
25,600 x 5,120 remainder table and a 4 x 5,120 quotient table, combined
with ``mult``) unless ``embedding`` says otherwise.  The full config's
layers hold 3,972,116,480 parameters each and the rest 655,385,600.
"""

from __future__ import annotations

from ..models.lm import LMConfig
from ..nn.mla import MLAConfig
from ..nn.moe import MoEConfig
from .common import embedding_spec, lm_api

ARCH, FAMILY, PARAMS_B = "deepseek-v2-236b", "moe", 238.0


def config(reduced: bool = False, embedding: str = "qr", num_collisions: int = 4) -> LMConfig:
    emb = embedding_spec(embedding, num_collisions)
    if reduced:
        return LMConfig(name=ARCH, vocab=512, d_model=64, n_layers=2, n_heads=4,
                        n_kv_heads=4, d_head=16, d_ff=128,
                        mla=MLAConfig(d_model=64, n_heads=4, q_lora=32, kv_lora=16,
                                      d_nope=16, d_rope=8, d_v=16),
                        moe=MoEConfig(n_experts=8, top_k=2, d_model=64, d_ff=96,
                                      groups=8),
                        n_shared_experts=2, embedding=emb,
                        param_dtype="float32", compute_dtype="float32", xent_chunk=16)
    return LMConfig(name=ARCH, vocab=102400, d_model=5120, n_layers=60, n_heads=128,
                    n_kv_heads=128, d_head=128, d_ff=1536,
                    mla=MLAConfig(d_model=5120, n_heads=128, q_lora=1536,
                                  kv_lora=512, d_nope=128, d_rope=64, d_v=128),
                    moe=MoEConfig(n_experts=160, top_k=6, d_model=5120, d_ff=1536,
                                  groups=256, capacity_factor=1.25),
                    n_shared_experts=2, embedding=emb)


def api(cfg, device="cuda"):
    return lm_api(cfg, PARAMS_B, accum=16, device=device)

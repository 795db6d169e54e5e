"""qwen3-14b: dense GQA, qk_norm, 40L x 5120, vocab 151,936. [hf:Qwen/Qwen3-8B; hf]"""

from __future__ import annotations

from ..models.lm import LMConfig
from .common import embedding_spec, lm_api

ARCH, FAMILY, PARAMS_B = "qwen3-14b", "dense", 14.7


def config(reduced: bool = False, embedding: str = "qr", num_collisions: int = 4) -> LMConfig:
    emb = embedding_spec(embedding, num_collisions)
    if reduced:
        return LMConfig(name=ARCH, vocab=512, d_model=64, n_layers=2, n_heads=4,
                        n_kv_heads=2, d_head=16, d_ff=128, qk_norm=True,
                        rope_theta=1e6, embedding=emb, param_dtype="float32",
                        compute_dtype="float32", xent_chunk=16)
    return LMConfig(name=ARCH, vocab=151936, d_model=5120, n_layers=40, n_heads=40,
                    n_kv_heads=8, d_head=128, d_ff=17408, qk_norm=True,
                    rope_theta=1e6, embedding=emb)


def api(cfg, device="cuda"):
    return lm_api(cfg, PARAMS_B, device=device)

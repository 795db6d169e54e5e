"""granite-8b: llama-arch, code model, 36L x 4096. [arXiv:2405.04324; hf]"""

from __future__ import annotations

from ..models.lm import LMConfig
from .common import embedding_spec, lm_api

ARCH, FAMILY, PARAMS_B = "granite-8b", "dense", 8.0


def config(reduced: bool = False, embedding: str = "qr", num_collisions: int = 4) -> LMConfig:
    emb = embedding_spec(embedding, num_collisions)
    if reduced:
        return LMConfig(name=ARCH, vocab=512, d_model=64, n_layers=2, n_heads=4,
                        n_kv_heads=2, d_head=16, d_ff=128, embedding=emb,
                        param_dtype="float32", compute_dtype="float32", xent_chunk=16)
    return LMConfig(name=ARCH, vocab=49152, d_model=4096, n_layers=36, n_heads=32,
                    n_kv_heads=8, d_head=128, d_ff=14336, embedding=emb)


def api(cfg, device="cuda"):
    return lm_api(cfg, PARAMS_B, device=device)

"""tinyllama-1.1b: llama2-arch small, 22L x 2048, GQA kv=4. [arXiv:2401.02385; hf]

The token vocabulary is the model's one categorical table: QR with
``num_collisions`` (c=4: an 8,000 x 2,048 remainder table and a 4 x 2,048
quotient table, combined with ``mult``) unless ``embedding`` says
otherwise.  The full config has 1,050,904,576 parameters in bf16.
"""

from __future__ import annotations

from ..models.lm import LMConfig
from .common import embedding_spec, lm_api

ARCH, FAMILY, PARAMS_B = "tinyllama-1.1b", "dense", 1.1


def config(reduced: bool = False, embedding: str = "qr", num_collisions: int = 4) -> LMConfig:
    emb = embedding_spec(embedding, num_collisions)
    if reduced:
        return LMConfig(name=ARCH, vocab=512, d_model=64, n_layers=2, n_heads=4,
                        n_kv_heads=2, d_head=16, d_ff=128, embedding=emb,
                        param_dtype="float32", compute_dtype="float32", xent_chunk=16)
    return LMConfig(name=ARCH, vocab=32000, d_model=2048, n_layers=22, n_heads=32,
                    n_kv_heads=4, d_head=64, d_ff=5632, embedding=emb)


def api(cfg, device="cuda"):
    return lm_api(cfg, PARAMS_B, device=device)

"""seamless-m4t-large-v2: enc-dec audio->text, vocab 256,206 (the most
embedding-dominated arch). [arXiv:2308.11596; hf]

The token vocabulary is QR with ``num_collisions`` (c=4: a 64,052 x 1,024
remainder table and a 4 x 1,024 quotient table, combined with ``mult``)
unless ``embedding`` says otherwise.  The full config has 1,436,418,048
parameters, 2,872,836,096 B in bf16.
"""

from __future__ import annotations

from ..models.encdec import EncDecConfig
from .common import embedding_spec, encdec_api

ARCH, FAMILY, PARAMS_B = "seamless-m4t-large-v2", "audio", 1.9


def config(reduced: bool = False, embedding: str = "qr", num_collisions: int = 4):
    emb = embedding_spec(embedding, num_collisions)
    if reduced:
        return EncDecConfig(name=ARCH, vocab=512, d_model=64, enc_layers=2,
                            dec_layers=2, n_heads=4, n_kv_heads=2, d_head=16,
                            d_ff=128, enc_ratio=4, embedding=emb,
                            param_dtype="float32", compute_dtype="float32",
                            xent_chunk=16)
    return EncDecConfig(name=ARCH, vocab=256206, d_model=1024, enc_layers=24,
                        dec_layers=24, n_heads=16, n_kv_heads=16, d_head=64,
                        d_ff=8192, enc_ratio=4, embedding=emb)


def api(cfg, device="cuda"):
    return encdec_api(cfg, PARAMS_B, accum=8, device=device)

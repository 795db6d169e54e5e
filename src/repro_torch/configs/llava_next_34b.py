"""llava-next-34b: yi-34b backbone + anyres patch stub. [hf:llava-hf; unverified]

The text vocabulary is QR with ``num_collisions`` (c=4: a 16,000 x 7,168
remainder table and a 4 x 7,168 quotient table, combined with ``mult``)
unless ``embedding`` says otherwise; the 1,152 patches bypass it.  The
full config has 34,147,642,368 parameters (68.3 GB in bf16), one layer
557,856,768 of them.
"""

from __future__ import annotations

from ..models.lm import LMConfig
from ..models.vlm import VLMConfig
from .common import embedding_spec, vlm_api

ARCH, FAMILY, PARAMS_B = "llava-next-34b", "vlm", 34.8


def config(reduced: bool = False, embedding: str = "qr", num_collisions: int = 4):
    emb = embedding_spec(embedding, num_collisions)
    if reduced:
        lm = LMConfig(name=ARCH, vocab=512, d_model=64, n_layers=2, n_heads=4,
                      n_kv_heads=2, d_head=16, d_ff=128, embedding=emb,
                      param_dtype="float32", compute_dtype="float32", xent_chunk=16)
        return VLMConfig(lm=lm, n_patches=8)
    lm = LMConfig(name=ARCH, vocab=64000, d_model=7168, n_layers=60, n_heads=56,
                  n_kv_heads=8, d_head=128, d_ff=20480, embedding=emb)
    return VLMConfig(lm=lm, n_patches=1152)  # anyres: 2 tiles x 576


def api(cfg, device="cuda"):
    return vlm_api(cfg, PARAMS_B, device=device)

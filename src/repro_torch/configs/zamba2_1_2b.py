"""zamba2-1.2b: Mamba2 backbone + shared attention blocks. [arXiv:2411.15242; hf]

6 blocks of 6 Mamba layers, each block followed by the one shared
attention (32 heads of 64) and MLP (d_ff 8,192), then 2 tail layers: 38
Mamba layers.  The token vocabulary is QR (c=4: 8,000 + 4 rows x 2,048,
``mult``) unless ``embedding`` says otherwise.  The full config has
1,121,330,048 parameters, 2,242,674,688 B.
"""

from __future__ import annotations

from ..models.hybrid import HybridLMConfig
from ..nn.ssm import SSMConfig
from .common import embedding_spec, hybrid_api

ARCH, FAMILY, PARAMS_B = "zamba2-1.2b", "hybrid", 1.2


def config(reduced: bool = False, embedding: str = "qr", num_collisions: int = 4):
    emb = embedding_spec(embedding, num_collisions)
    if reduced:
        return HybridLMConfig(name=ARCH, vocab=512, d_model=64, n_blocks=2,
                              block_len=2, n_tail=1,
                              ssm=SSMConfig(d_model=64, d_state=8, headdim=8, chunk=16),
                              n_heads=4, n_kv_heads=4, d_head=16, d_ff=128,
                              embedding=emb, param_dtype="float32",
                              compute_dtype="float32", xent_chunk=16)
    # 6 blocks x 6 mamba layers + shared attn, + 2 tail = 38 mamba layers
    return HybridLMConfig(name=ARCH, vocab=32000, d_model=2048, n_blocks=6,
                          block_len=6, n_tail=2,
                          ssm=SSMConfig(d_model=2048, d_state=64, headdim=64),
                          n_heads=32, n_kv_heads=32, d_head=64, d_ff=8192,
                          embedding=emb)


def api(cfg, device="cuda"):
    return hybrid_api(cfg, PARAMS_B, device=device)

"""mamba2-370m: pure SSD stack, attention-free. [arXiv:2405.21060; unverified]

The token vocabulary is QR with ``num_collisions`` (c=4: a 12,570 x 1,024
remainder table and a 4 x 1,024 quotient table, combined with ``mult``)
unless ``embedding`` says otherwise.  The full config has 381,214,208
parameters, 762,437,632 B (bf16, with ``A_log``, ``D`` and ``dt_bias`` in
f32).
"""

from __future__ import annotations

from ..models.hybrid import MambaLMConfig
from ..nn.ssm import SSMConfig
from .common import embedding_spec, mamba_api

ARCH, FAMILY, PARAMS_B = "mamba2-370m", "ssm", 0.37


def config(reduced: bool = False, embedding: str = "qr", num_collisions: int = 4):
    emb = embedding_spec(embedding, num_collisions)
    if reduced:
        return MambaLMConfig(name=ARCH, vocab=512, d_model=64, n_layers=2,
                             ssm=SSMConfig(d_model=64, d_state=8, headdim=8, chunk=16),
                             embedding=emb, param_dtype="float32",
                             compute_dtype="float32", xent_chunk=16)
    return MambaLMConfig(name=ARCH, vocab=50280, d_model=1024, n_layers=48,
                         ssm=SSMConfig(d_model=1024, d_state=128, headdim=64),
                         embedding=emb)


def api(cfg, device="cuda"):
    return mamba_api(cfg, PARAMS_B, accum=2, device=device)

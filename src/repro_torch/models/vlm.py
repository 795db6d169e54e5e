"""VLM wrapper (llava-next-34b): a yi-34b backbone and an anyres patch
stub, the JAX package's ``models/vlm.py``.

The vision tower is a stub, as in the reference: the inputs carry
precomputed anyres patch embeddings ``(B, P, d_model)``.  The multimodal
projector (a 2-layer MLP with a tanh-approximated gelu, as in LLaVA) and
the LM backbone (``models/lm.py``) are real.  The sequence is the
projected patches, then the text.  Text tokens go through the
(QR-compressible) vocabulary; patches bypass it, so the paper's
technique applies to the text side only: serving looks the text tokens
up through ``lm.embed_serving`` (one K1 launch per call on the card for a
QR mult/add pair), training through the plain ``embed.apply``.

``vlm_prefill`` fills the cache at positions ``0 .. P + St - 1``, so the
next decode step writes index ``P + St``.  ``vlm_decode_step`` is the
LM's ``decode_step`` at whatever ``pos`` it is given, as the reference's:
its callers (``launch/serve.py``, ``chip_smoke.py``) offset the position
by the ``P`` patch rows (ROADMAP §3 finding 13).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as tf

from ..dist.sharding import constrain_batch
from ..nn.layers import dense, dense_init
from . import lm as lm_mod
from .lm import LMConfig, chunked_xent

__all__ = ["VLMConfig", "vlm_init", "vlm_loss_fn", "vlm_forward", "vlm_make_cache",
           "vlm_prefill", "vlm_decode_step"]


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    lm: LMConfig = LMConfig()
    n_patches: int = 1152  # anyres: e.g. 2 tiles × 576

    @property
    def name(self):
        return self.lm.name


def vlm_init(generator, cfg: VLMConfig, device="cuda"):
    """The LM's tree, then the two projector weights, drawn from
    ``generator`` on ``device``."""
    d = cfg.lm.d_model
    return {"lm": lm_mod.init(generator, cfg.lm, device),
            "proj1": dense_init(generator, d, d, cfg.lm.pdtype, device=device),
            "proj2": dense_init(generator, d, d, cfg.lm.pdtype, device=device)}


def _project(params, patches, cfg: VLMConfig):
    h = dense(params["proj1"], patches.to(cfg.lm.cdtype), cfg.lm.cdtype)
    return dense(params["proj2"], tf.gelu(h, approximate="tanh"), cfg.lm.cdtype)


def _prefix_hidden(params, patches, text_h, cfg: VLMConfig):
    """The projected patches, then the embedded text ``text_h``."""
    return constrain_batch(torch.cat([_project(params, patches, cfg), text_h], dim=1))


def vlm_forward(params, patches, text_h, cfg: VLMConfig):
    """The LM stack over the patches and the embedded text ``text_h`` (B,
    St, D): the final-normed hidden states of every position and the
    auxiliary loss."""
    return lm_mod.forward_hidden(params["lm"], _prefix_hidden(params, patches, text_h, cfg),
                                 cfg.lm)


def vlm_loss_fn(params, batch, cfg: VLMConfig):
    """batch: patches (B,P,D), tokens (B,St), labels (B,St), mask (B,St);
    labels and mask are zero over the patch positions."""
    h, aux = vlm_forward(params, batch["patches"],
                         lm_mod.embed_tokens(params["lm"], batch["tokens"], cfg.lm), cfg)
    b, p = batch["patches"].shape[:2]
    labels, mask = batch["labels"], batch["mask"]
    labels = torch.cat([labels.new_zeros((b, p)), labels], dim=1)
    mask = torch.cat([mask.new_zeros((b, p)), mask], dim=1)
    loss = chunked_xent(h, labels, mask, params["lm"]["lm_head"]["w"], cfg.lm.xent_chunk)
    return loss + aux, {"xent": loss}


def vlm_make_cache(cfg: VLMConfig, batch: int, max_len: int, device="cuda"):
    return lm_mod.make_decode_cache(cfg.lm, batch, max_len, device)


def vlm_prefill(params, patches, tokens, cache, cfg: VLMConfig):
    """Fill the cache from the patches and the prompt (positions ``0 .. P +
    St - 1``); returns (last-position logits (B, 1, V) f32, cache)."""
    h = _prefix_hidden(params, patches, lm_mod.embed_serving(params["lm"], tokens, cfg.lm), cfg)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    h, cache = lm_mod._run_with_cache(params["lm"], h, cache, cfg.lm, positions, None)
    logits = dense(params["lm"]["lm_head"], h[:, -1:], cfg.lm.cdtype).to(torch.float32)
    return logits, cache


def vlm_decode_step(params, tokens, pos: int, cache, cfg: VLMConfig):
    """The LM's decode step at cache index ``pos``."""
    return lm_mod.decode_step(params["lm"], tokens, pos, cache, cfg.lm)

"""Deep & Cross Network (Wang et al. 2017) — the paper's second test network.

Embeds all categoricals (via the same ``EmbeddingSpec`` machinery as DLRM),
concatenates with the dense features into x0, and runs a 6-layer cross
network ``x_{l+1} = x0 · (x_l · w_l) + b_l + x_l`` in parallel with a deep
MLP; their concatenation feeds the CTR logit.

As in the reference, ``DCNConfig`` has no ``use_kernel``: the embed stage
takes the plain per-table route.  A mixed-width plan's narrow tables are
projected back to ``emb_dim`` (``dlrm.proj_init``) before they join x0.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import CompositionalEmbedding, EmbeddingSpec
from .dlrm import _mlp_apply, _mlp_init, embed_features, proj_init, tables_for

__all__ = ["DCNConfig", "dcn_init", "dcn_forward", "dcn_loss_fn",
           "dcn_forward_from_features"]


@dataclasses.dataclass(frozen=True)
class DCNConfig:
    name: str = "dcn"
    dense_dim: int = 13
    table_sizes: tuple[int, ...] = ()
    emb_dim: int = 16
    cross_layers: int = 6
    deep_mlp: tuple[int, ...] = (512, 256, 64)
    embedding: EmbeddingSpec = EmbeddingSpec()
    param_dtype: str = "float32"

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)


def _x0_dim(cfg, modules) -> int:
    d = cfg.dense_dim
    for m in modules:
        if cfg.embedding.kind == "feature" and isinstance(m, CompositionalEmbedding):
            d += cfg.emb_dim * len(m.partitions)
        else:
            d += cfg.emb_dim
    return d


def dcn_init(cfg: DCNConfig, generator: torch.Generator, device="cuda"):
    """Random parameters drawn from ``generator``, which lives on ``device``."""
    modules = tables_for(cfg)
    d0 = _x0_dim(cfg, modules)
    cross = []
    for _ in range(cfg.cross_layers):
        w = torch.randn((d0,), generator=generator, device=device,
                        dtype=torch.float32) * (1.0 / d0) ** 0.5
        cross.append({"w": w.to(cfg.pdtype),
                      "b": torch.zeros((d0,), dtype=cfg.pdtype, device=device)})
    params = {
        "tables": [m.init(generator, device) for m in modules],
        "cross": cross,
        "deep": _mlp_init(generator, (d0,) + cfg.deep_mlp, cfg.pdtype, device),
        "out": _mlp_init(generator, (d0 + cfg.deep_mlp[-1], 1), cfg.pdtype, device),
    }
    proj = proj_init(generator, modules, cfg, device)
    if proj:  # mixed-width plan: project narrow tables into the x0 width
        params["proj"] = proj
    return params


def dcn_forward_from_features(params, dense_x, feats, cfg: DCNConfig):
    """Cross + deep half given precomputed table features (``(B, F, D)``
    stacked or a list of ``(B, D)``)."""
    dense_x = dense_x.to(cfg.pdtype)
    if not isinstance(feats, (list, tuple)):
        feats = [feats[:, i, :] for i in range(feats.shape[1])]
    x0 = torch.cat([dense_x] + [f.to(dense_x.dtype) for f in feats], dim=-1)
    x = x0
    for layer in params["cross"]:
        x = x0 * (x @ layer["w"])[:, None] + layer["b"] + x
    deep = _mlp_apply(params["deep"], x0, "deep")
    out = torch.cat([x, deep], dim=-1)
    return _mlp_apply(params["out"], out, "out", final_linear=True)[:, 0]


def dcn_forward(params, dense_x, sparse_idx, cfg: DCNConfig, mask=None):
    feats = embed_features(params["tables"], sparse_idx, cfg, mask=mask,
                           proj=params.get("proj"))
    return dcn_forward_from_features(params, dense_x, feats, cfg)


def dcn_loss_fn(params, batch, cfg: DCNConfig):
    logits = dcn_forward(params, batch["dense"], batch["sparse"], cfg).to(torch.float32)
    y = batch["label"].to(torch.float32)
    loss = torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))
    acc = torch.mean(((logits > 0) == (y > 0.5)).to(torch.float32))
    return loss, {"bce": loss, "acc": acc}

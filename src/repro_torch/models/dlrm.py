"""Facebook DLRM (Naumov et al. 2019) — the paper's primary test network.

Bottom MLP over 13 dense features → pairwise dot interaction with the 26
categorical embeddings → top MLP → CTR logit.  Every embedding table is
built through ``repro_torch.core.make_embedding``, so ``EmbeddingSpec``
switches the whole model between the paper's table kinds.

Parameters are a plain tree of tensors with the reference's layout:
``bottom``/``top`` are lists of ``{"w": (in, out), "b": (out,)}`` applied
as ``x @ w + b``; ``tables[i]`` holds ``table`` or ``table_0``/``table_1``
(each possibly a quantized dict); ``proj[str(i)]`` holds mixed-width
projections.
"""

from __future__ import annotations

import dataclasses
import numpy as np
import torch

from ..core import (CompositionalEmbedding, EmbeddingSpec, FullEmbedding,
                    HashEmbedding, bag_pool, make_embedding)
from ..kernels import ops

__all__ = ["DLRMConfig", "dlrm_init", "dlrm_forward", "dlrm_loss_fn",
           "dlrm_num_params", "tables_for", "embed_features",
           "dlrm_forward_from_features"]

# The dense MLPs and the plain interaction stay true f32 on the card: no
# TF32 in float32 matrix products (PyTorch's default, stated here so the
# port does not depend on it).
torch.backends.cuda.matmul.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm"
    dense_dim: int = 13
    table_sizes: tuple[int, ...] = ()
    emb_dim: int = 16
    bottom_mlp: tuple[int, ...] = (512, 256, 64)
    top_mlp: tuple[int, ...] = (512, 256)
    embedding: EmbeddingSpec = EmbeddingSpec()
    use_kernel: bool = False     # route lookups, pooling and interaction through the kernels
    param_dtype: str = "float32"

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)


def tables_for(cfg) -> list:
    """Embedding module per categorical feature (threshold rule applies)."""
    return [make_embedding(n, cfg.emb_dim, cfg.embedding, cfg.pdtype, feature=i)
            for i, n in enumerate(cfg.table_sizes)]


def _feature_mode(cfg) -> bool:
    return cfg.embedding.kind == "feature"


def _project(feat, proj, i):
    """Map one feature into the interaction width (identity when the
    table already is ``emb_dim`` wide — no entry, no matmul)."""
    w = None if proj is None else proj.get(str(i))
    return feat if w is None else feat @ w


def _mlp_init(generator, dims, dtype, device):
    layers = []
    for i, o in zip(dims[:-1], dims[1:]):
        w = torch.randn((i, o), generator=generator, device=device,
                        dtype=torch.float32) * (2.0 / i) ** 0.5
        layers.append({"w": w.to(dtype), "b": torch.zeros((o,), dtype=dtype, device=device)})
    return layers


def _mlp_apply(layers, x, final_linear=False):
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if not (final_linear and i == len(layers) - 1):
            x = torch.relu(x)
    return x


def _num_features(cfg, modules) -> int:
    f = 1  # bottom-MLP output participates in the interaction
    for mod in modules:
        if _feature_mode(cfg) and isinstance(mod, CompositionalEmbedding):
            f += len(mod.partitions)
        else:
            f += 1
    return f


def dlrm_init(cfg: DLRMConfig, generator: torch.Generator, device="cuda"):
    """Random parameters drawn from ``generator``, which lives on ``device``."""
    modules = tables_for(cfg)
    f = _num_features(cfg, modules)
    interact_dim = f * (f - 1) // 2 + cfg.emb_dim
    return {
        "bottom": _mlp_init(generator, (cfg.dense_dim,) + cfg.bottom_mlp + (cfg.emb_dim,),
                            cfg.pdtype, device),
        "top": _mlp_init(generator, (interact_dim,) + cfg.top_mlp + (1,), cfg.pdtype, device),
        "tables": [m.init(generator, device) for m in modules],
    }


def embed_features(table_params, sparse_idx, cfg, modules=None, mask=None, proj=None):
    """Per-feature pooled embedding list — the serving stack's embed stage.

    ``sparse_idx``: one-hot ``(B, F)`` or multi-hot ``(B, F, L)`` with
    ``mask (B, F, L)`` (masked slots contribute nothing, so an empty bag
    pools to the exact zero vector).  Tables may be dense or row-quantized.
    With ``cfg.use_kernel`` every multi-hot full/hash table or mult/add QR
    pair goes through the fused serving kernel, and every one-hot mult/add
    QR pair through ``ops.qr_lookup`` (K1 dense, K5 int8).  Returns a list of
    ``(B, D)`` features (feature mode expands per partition, one-hot only).
    """
    modules = tables_for(cfg) if modules is None else modules
    multihot = sparse_idx.dim() == 3
    use_kernel = getattr(cfg, "use_kernel", False)
    feats = []
    for i, mod in enumerate(modules):
        tp = table_params[i]
        qr2 = isinstance(mod, CompositionalEmbedding) \
            and len(mod.partitions) == 2 and mod.op in ("mult", "add")
        if multihot:
            idx = sparse_idx[:, i, :]
            mk = mask[:, i, :] if mask is not None \
                else torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
            if _feature_mode(cfg) and isinstance(mod, CompositionalEmbedding):
                raise NotImplementedError(
                    "feature-generation mode has no multi-hot serving path")
            single = isinstance(mod, (FullEmbedding, HashEmbedding))
            if use_kernel and (qr2 or single):
                w = None if proj is None else proj.get(str(i))
                if qr2:
                    pooled = ops.serve_bag_pool(idx, mk, tp["table_0"], tp["table_1"],
                                                op=mod.op, proj=w)
                else:
                    fold = idx % mod.m if isinstance(mod, HashEmbedding) else idx
                    pooled = ops.serve_bag_pool(fold, mk, tp["table"], proj=w)
                feats.append(pooled)
            else:
                feats.append(_project(bag_pool(mod, tp, idx, mk), proj, i))
            continue
        idx = sparse_idx[:, i]
        if _feature_mode(cfg) and isinstance(mod, CompositionalEmbedding):
            feats.extend(mod.partition_embeddings(tp, idx))
        elif use_kernel and qr2:
            feats.append(_project(ops.qr_lookup(idx, tp["table_0"], tp["table_1"], op=mod.op),
                                  proj, i))
        else:
            feats.append(_project(mod.apply(tp, idx), proj, i))
    return feats


def dlrm_forward_from_features(params, dense_x, feats, cfg: DLRMConfig):
    """Dense half of the model: bottom MLP + interaction + top MLP.

    ``feats``: stacked table features ``(B, F-1, D)`` or a list of ``(B, D)``.
    """
    z = _mlp_apply(params["bottom"], dense_x.to(cfg.pdtype))  # (B, D)
    if isinstance(feats, (list, tuple)):
        feats = torch.stack(feats, dim=1)
    x = torch.cat([z[:, None, :], feats.to(z.dtype)], dim=1)
    inter = ops.dlrm_interact(x) if cfg.use_kernel else _interact_plain(x)
    top_in = torch.cat([z, inter], dim=-1)
    return _mlp_apply(params["top"], top_in, final_linear=True)[:, 0]


def dlrm_forward(params, dense_x, sparse_idx, cfg: DLRMConfig, mask=None):
    """dense_x: (B, 13) float; sparse_idx: (B, 26) int (or (B, 26, L)
    multi-hot with ``mask``) → logits (B,)."""
    feats = embed_features(params["tables"], sparse_idx, cfg, mask=mask,
                           proj=params.get("proj"))
    return dlrm_forward_from_features(params, dense_x, feats, cfg)


def _interact_plain(x):
    scores = torch.einsum("bfd,bgd->bfg", x, x)
    i, j = np.tril_indices(x.shape[1], k=-1)
    return scores[:, torch.as_tensor(i, device=x.device), torch.as_tensor(j, device=x.device)]


def dlrm_loss_fn(params, batch, cfg: DLRMConfig):
    """batch: dense (B,13), sparse (B,26) int, label (B,) in {0,1}."""
    logits = dlrm_forward(params, batch["dense"], batch["sparse"], cfg).to(torch.float32)
    y = batch["label"].to(torch.float32)
    # stable BCE-with-logits: max(x, 0) - x·y + log1p(exp(-|x|))
    loss = torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))
    acc = torch.mean(((logits > 0) == (y > 0.5)).to(torch.float32))
    return loss, {"bce": loss, "acc": acc}


def dlrm_num_params(cfg: DLRMConfig) -> int:
    modules = tables_for(cfg)
    n = sum(m.num_params for m in modules)
    n += sum(m.out_dim * cfg.emb_dim for m in modules
             if m.out_dim != cfg.emb_dim)  # mixed-dim projections
    dims_b = (cfg.dense_dim,) + cfg.bottom_mlp + (cfg.emb_dim,)
    f = _num_features(cfg, modules)
    dims_t = (f * (f - 1) // 2 + cfg.emb_dim,) + cfg.top_mlp + (1,)
    for d in (dims_b, dims_t):
        n += sum(i * o + o for i, o in zip(d[:-1], d[1:]))
    return n

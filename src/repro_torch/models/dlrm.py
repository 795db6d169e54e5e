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
from ..dist.sharding import is_dtensor, kernel_map
from ..kernels import ops
from ..obs.trace import span

__all__ = ["DLRMConfig", "dlrm_init", "dlrm_forward", "dlrm_loss_fn",
           "dlrm_num_params", "tables_for", "embed_features", "proj_init",
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
    """Embedding module per categorical feature (threshold rule applies).

    ``cfg.embedding`` may be a single ``EmbeddingSpec`` (uniform strategy)
    or a ``repro_torch.plan.MemoryPlan`` (per-feature strategies and widths
    from the memory-budget planner — the feature index routes the lookup).
    """
    return [make_embedding(n, cfg.emb_dim, cfg.embedding, cfg.pdtype, feature=i)
            for i, n in enumerate(cfg.table_sizes)]


def _feature_mode(cfg) -> bool:
    return cfg.embedding.kind == "feature"


def proj_init(generator, modules, cfg, device="cuda"):
    """Per-feature learned projections ``(d_i, D)`` for mixed-dimension
    plans — only features whose table width differs from ``cfg.emb_dim``
    get an entry (keyed by the feature index as a string), scaled by
    ``(1/d_i)**0.5``, so uniform-width configs keep the same parameter tree
    (no ``"proj"`` key at all).  Drawn from ``generator`` after every
    other leaf, so adding a projection never changes any other draw."""
    out = {}
    for i, mod in enumerate(modules):
        d = mod.out_dim
        if d != cfg.emb_dim:
            w = torch.randn((d, cfg.emb_dim), generator=generator, device=device,
                            dtype=torch.float32) * (1.0 / d) ** 0.5
            out[str(i)] = w.to(cfg.pdtype)
    return out


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


def _mlp_apply(layers, x, which: str, final_linear=False):
    """``x`` through the MLP ``layers`` in a ``repro.mlp`` span whose args
    name it (``which``: bottom, top, deep or out)."""
    with span("repro.mlp", which=which):
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
    params = {
        "bottom": _mlp_init(generator, (cfg.dense_dim,) + cfg.bottom_mlp + (cfg.emb_dim,),
                            cfg.pdtype, device),
        "top": _mlp_init(generator, (interact_dim,) + cfg.top_mlp + (1,), cfg.pdtype, device),
        "tables": [m.init(generator, device) for m in modules],
    }
    proj = proj_init(generator, modules, cfg, device)
    if proj:  # mixed-width plan: project narrow tables into the interaction
        params["proj"] = proj
    return params


def _qr2(mod) -> bool:
    return isinstance(mod, CompositionalEmbedding) and len(mod.partitions) == 2 \
        and mod.op in ("mult", "add")


def _trains_through_k6(mod, tp, device) -> bool:
    """Whether a one-hot feature's backward goes through K6: a dense f32 or
    bf16 mult/add QR pair on the ids' CUDA device, plain tensors of one
    dtype and width, a table of which requires grad."""
    if device.type != "cuda" or not _qr2(mod):
        return False
    w0, w1 = tp["table_0"], tp["table_1"]
    return (all(isinstance(w, torch.Tensor) and not is_dtensor(w) and w.device == device
                and w.dtype == w0.dtype and w.dim() == 2 and w.shape[1] == w0.shape[1]
                and w.is_contiguous() for w in (w0, w1))
            and w0.dtype in (torch.float32, torch.bfloat16)
            and (w0.requires_grad or w1.requires_grad))


def _embed_trained_pairs(table_params, sparse_idx, modules, gathers):
    """Under grad mode, the one-hot features whose QR pair trains through
    K6 (``_trains_through_k6``, no ``gathers`` hook), looked up through
    ``ops.qr_pairs``: one call per dtype and width, of at most
    ``ops.MAX_PAIRS`` pairs.  Returns ``{feature: (B, D) output}``; the
    forward is the per-table route's gathers and combine, and the backward
    of each call one K6 call for its pairs."""
    if not torch.is_grad_enabled():
        return {}
    groups = {}
    for i, (mod, tp) in enumerate(zip(modules, table_params)):
        if (gathers is None or gathers[i] is None) \
                and _trains_through_k6(mod, tp, sparse_idx.device):
            groups.setdefault((tp["table_0"].dtype, tp["table_0"].shape[1]), []).append(i)
    out = {}
    for feats in groups.values():
        for s in range(0, len(feats), ops.MAX_PAIRS):
            part = feats[s:s + ops.MAX_PAIRS]
            rem = [modules[i].partitions[0].bucket(sparse_idx[:, i]) for i in part]
            quo = [modules[i].partitions[1].bucket(sparse_idx[:, i]) for i in part]
            tables = [w for i in part for w in (table_params[i]["table_0"],
                                                table_params[i]["table_1"])]
            out.update(zip(part, ops.qr_pairs(rem, quo, tables, [modules[i].op for i in part])))
    return out


def _embed_grouped(table_params, sparse_idx, modules, mask, proj, gathers=None):
    """The embed stage in one kernel launch — K4 over every table for
    multi-hot ids, K5 (int8) or K1 (dense) for one-hot ids — as a ``(B, F,
    D)`` tensor, or None where the per-table route stays: a set of tables
    the fused kernels cannot serve together (``ops``' rules: one-hot takes
    only QR pairs, all int8 or all dense of one dtype).  Multi-hot tables of
    a kind K4 does not take (a mixed-radix, CRT or path-based table, a
    concat pair) pool through ``bag_pool`` beside the one launch over all
    the others, and so do features with a ``gathers`` hook; one-hot, any
    such table keeps the per-table route."""
    specs, rest = [], []
    for i, (mod, tp) in enumerate(zip(modules, table_params)):
        w = None if proj is None else proj.get(str(i))
        if gathers is not None and gathers[i] is not None and sparse_idx.dim() == 3:
            specs.append(None)
            rest.append(i)
        elif _qr2(mod):
            specs.append((tp["table_0"], tp["table_1"], 0, mod.op, w))
        elif isinstance(mod, (FullEmbedding, HashEmbedding)):
            m = mod.m if isinstance(mod, HashEmbedding) else 0
            specs.append((tp["table"], None, m, "mult", w))
        else:
            specs.append(None)
            rest.append(i)
    if sparse_idx.dim() != 3:
        return None if rest else ops.qr_lookup_grouped(sparse_idx, specs)
    if not rest:
        return ops.serve_bag_pool_grouped(sparse_idx, mask, specs)
    kernel = [i for i, spec in enumerate(specs) if spec is not None]
    if not kernel:
        return None
    sel = torch.as_tensor(kernel, device=sparse_idx.device)
    pooled = ops.serve_bag_pool_grouped(sparse_idx[:, sel], None if mask is None else mask[:, sel],
                                        [specs[i] for i in kernel])
    if pooled is None:
        return None
    feats = dict(zip(kernel, pooled.unbind(1)))
    for i in rest:
        idx = sparse_idx[:, i, :]
        mk = mask[:, i, :] if mask is not None \
            else torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
        g = None if gathers is None else gathers[i]
        feats[i] = _project(bag_pool(modules[i], table_params[i], idx, mk, gather=g), proj, i)
    return torch.stack([feats[i] for i in range(len(modules))], dim=1)


def embed_features(table_params, sparse_idx, cfg, modules=None, mask=None, proj=None,
                   gathers=None):
    """Per-feature pooled embeddings — the serving stack's embed stage.

    ``sparse_idx``: one-hot ``(B, F)`` or multi-hot ``(B, F, L)`` with
    ``mask (B, F, L)`` (masked slots contribute nothing, so an empty bag
    pools to the exact zero vector).  Tables may be dense or row-quantized.
    With ``cfg.use_kernel``, when every table is one the fused kernels take
    (multi-hot: full and hash tables and mult/add QR pairs; one-hot:
    mult/add QR pairs, all int8 or all dense of one dtype), all features go
    through one grouped launch (K4 multi-hot, K5 or K1 one-hot) and come
    back stacked as ``(B, F, D)``.
    Otherwise each multi-hot full/hash table or mult/add QR pair goes
    through the fused serving kernel, and each one-hot mult/add QR pair
    through ``ops.qr_lookup`` (K1 dense, K5 int8), and the result is a list
    of ``(B, D)`` features (feature mode expands per partition, one-hot
    only).  Without ``cfg.use_kernel``, under grad mode, the one-hot dense
    mult/add QR pairs on the card whose tables require grad go through
    ``ops.qr_pairs`` (the same gathers and combine, with K6 as their
    backward); every other feature, and every feature on the CPU, takes its
    module's ``apply``.

    ``gathers`` (optional, one per feature, entries may be ``None``)
    substitutes each multi-hot feature's row fetch
    (``core.compositional._gather``) — the sharded serving path fetches
    remote rows through it.  A feature with a hook takes the plain
    ``bag_pool``, never a kernel (which gathers locally); every other
    feature keeps its kernel route, the grouped K4 included.

    The stage is one ``repro.embed`` span.
    """
    with span("repro.embed"):
        modules = tables_for(cfg) if modules is None else modules
        multihot = sparse_idx.dim() == 3
        use_kernel = getattr(cfg, "use_kernel", False)
        if use_kernel and not _feature_mode(cfg):
            grouped = _embed_grouped(table_params, sparse_idx, modules, mask, proj, gathers)
            if grouped is not None:
                return grouped
        trained = {} if multihot or use_kernel or _feature_mode(cfg) else \
            _embed_trained_pairs(table_params, sparse_idx, modules, gathers)
        feats = []
        for i, mod in enumerate(modules):
            tp = table_params[i]
            qr2 = _qr2(mod)
            if multihot:
                idx = sparse_idx[:, i, :]
                mk = mask[:, i, :] if mask is not None \
                    else torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
                if _feature_mode(cfg) and isinstance(mod, CompositionalEmbedding):
                    raise NotImplementedError(
                        "feature-generation mode has no multi-hot serving path")
                g = None if gathers is None else gathers[i]
                single = isinstance(mod, (FullEmbedding, HashEmbedding))
                if use_kernel and g is None and (qr2 or single):
                    w = None if proj is None else proj.get(str(i))
                    if qr2:
                        pooled = ops.serve_bag_pool(idx, mk, tp["table_0"], tp["table_1"],
                                                    op=mod.op, proj=w)
                    else:
                        fold = idx % mod.m if isinstance(mod, HashEmbedding) else idx
                        pooled = ops.serve_bag_pool(fold, mk, tp["table"], proj=w)
                    feats.append(pooled)
                else:
                    feats.append(_project(bag_pool(mod, tp, idx, mk, gather=g), proj, i))
                continue
            idx = sparse_idx[:, i]
            if _feature_mode(cfg) and isinstance(mod, CompositionalEmbedding):
                feats.extend(mod.partition_embeddings(tp, idx))
            elif use_kernel and qr2:
                feats.append(_project(ops.qr_lookup(idx, tp["table_0"], tp["table_1"], op=mod.op),
                                      proj, i))
            elif i in trained:
                feats.append(_project(trained[i], proj, i))
            else:
                feats.append(_project(mod.apply(tp, idx), proj, i))
        return feats


def dlrm_forward_from_features(params, dense_x, feats, cfg: DLRMConfig):
    """Dense half of the model: bottom MLP + interaction + top MLP.

    ``feats``: stacked table features ``(B, F-1, D)`` or a list of ``(B, D)``.
    With ``cfg.use_kernel`` the interaction kernel reads ``z`` and the
    features in place and writes the top MLP's input itself.  The
    interaction, the features' stacking included, is a ``repro.interact``
    span; each MLP a ``repro.mlp`` span.
    """
    z = _mlp_apply(params["bottom"], dense_x.to(cfg.pdtype), "bottom")  # (B, D)
    with span("repro.interact"):
        if isinstance(feats, (list, tuple)):
            feats = torch.stack(feats, dim=1)
        feats = feats.to(z.dtype)
        if cfg.use_kernel:
            top_in = kernel_map(ops.dlrm_interact_concat, (z, feats))
        else:
            x = torch.cat([z[:, None, :], feats], dim=1)
            top_in = torch.cat([z, _interact_plain(x)], dim=-1)
    return _mlp_apply(params["top"], top_in, "top", final_linear=True)[:, 0]


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

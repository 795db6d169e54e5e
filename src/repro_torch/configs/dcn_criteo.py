"""Deep & Cross Network on Criteo — the paper's second §5 model (6 cross
layers, deep 512-256-64, D=16)."""

from __future__ import annotations

import dataclasses

from ..data.criteo import KAGGLE_TABLE_SIZES, CriteoSpec, batch_at
from ..models.dcn import DCNConfig, dcn_forward, dcn_init, dcn_loss_fn
from ..optim import optimizers as opt
from .common import ModelApi, embedding_spec, resolve_plan
from .dlrm_criteo import REDUCED_SIZES, criteo_train_batch

ARCH, FAMILY, PARAMS_B = "dcn-criteo", "rec", 0.54


def config(reduced: bool = False, embedding: str = "qr", num_collisions: int = 4,
           threshold: int = 0, op: str = "mult", path_hidden: int = 64,
           plan=None) -> DCNConfig:
    sizes = REDUCED_SIZES if reduced else KAGGLE_TABLE_SIZES
    if plan is not None:
        emb = resolve_plan(plan, sizes)
        return DCNConfig(name=ARCH, table_sizes=sizes, emb_dim=emb.emb_dim, cross_layers=6,
                         deep_mlp=(512, 256, 64), embedding=emb)
    emb = dataclasses.replace(embedding_spec(embedding, num_collisions),
                              threshold=threshold, op=op, path_hidden=path_hidden)
    return DCNConfig(name=ARCH, table_sizes=sizes, emb_dim=16, cross_layers=6,
                     deep_mlp=(512, 256, 64), embedding=emb)


def api(cfg, device="cuda") -> ModelApi:
    """Parameters and batches on ``device`` as ``dlrm_criteo.api``'s, and
    AMSGrad (1e-3), the paper's best optimizer for ``mult``."""
    spec = CriteoSpec(table_sizes=cfg.table_sizes, zipf=1.5, noise=0.5)
    return ModelApi(
        name=cfg.name, cfg=cfg,
        init=lambda generator: dcn_init(cfg, generator, device),
        loss_fn=lambda p, b: dcn_loss_fn(p, b, cfg),
        optimizer=opt.adam(1e-3, amsgrad=True),
        train_batch=lambda shape: criteo_train_batch(cfg, shape),
        batch_fn=lambda step, shape: batch_at(0, step, shape.global_batch, spec, device),
        predict=lambda p, b: dcn_forward(p, b["dense"], b["sparse"], cfg))

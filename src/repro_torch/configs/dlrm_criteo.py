"""Facebook DLRM on Criteo — the paper's own §5 model (bottom 512-256-64,
top 512-256, D=16)."""

from __future__ import annotations

import dataclasses

from ..data.criteo import KAGGLE_TABLE_SIZES, CriteoSpec, batch_at
from ..models.dlrm import DLRMConfig, dlrm_forward, dlrm_init, dlrm_loss_fn
from .common import ModelApi, embedding_spec

ARCH, FAMILY, PARAMS_B = "dlrm-criteo", "rec", 0.54

REDUCED_SIZES = (1000, 200, 50000, 12000, 31, 24, 12517, 633, 3, 931)


def config(reduced: bool = False, embedding: str = "qr", num_collisions: int = 4,
           threshold: int = 0, op: str = "mult", path_hidden: int = 64,
           plan=None) -> DLRMConfig:
    if plan is not None:
        raise NotImplementedError("memory plans need the planner "
                                  "(ROADMAP, modules to port: item 13)")
    sizes = REDUCED_SIZES if reduced else KAGGLE_TABLE_SIZES
    emb = dataclasses.replace(embedding_spec(embedding, num_collisions),
                              threshold=threshold, op=op, path_hidden=path_hidden)
    return DLRMConfig(name=ARCH, table_sizes=sizes, emb_dim=16,
                      bottom_mlp=(512, 256, 64), top_mlp=(512, 256), embedding=emb)


def api(cfg, device="cuda") -> ModelApi:
    """The reference's ``api(cfg)`` for scoring: parameters drawn from a
    ``torch.Generator`` on ``device``, and batches from ``batch_at(0, step)``
    on ``device``, the stream the reference's benchmarks train and
    evaluate on (``zipf=1.5``, ``noise=0.5``)."""
    spec = CriteoSpec(table_sizes=cfg.table_sizes, zipf=1.5, noise=0.5)
    return ModelApi(
        name=cfg.name, cfg=cfg,
        init=lambda generator: dlrm_init(cfg, generator, device),
        loss_fn=lambda p, b: dlrm_loss_fn(p, b, cfg),
        batch_fn=lambda step, shape: batch_at(0, step, shape.global_batch, spec, device),
        predict=lambda p, b: dlrm_forward(p, b["dense"], b["sparse"], cfg))

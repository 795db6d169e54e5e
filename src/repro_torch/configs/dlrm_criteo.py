"""Facebook DLRM on Criteo — the paper's own §5 model (bottom 512-256-64,
top 512-256, D=16)."""

from __future__ import annotations

import dataclasses

from ..data.criteo import KAGGLE_TABLE_SIZES
from ..models.dlrm import DLRMConfig
from .common import embedding_spec

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

"""Deep & Cross Network (Wang et al. 2017), plain: ``x0 = [dense,
features]``, cross layers ``x ← x0 · (x · w) + b + x``, a deep ReLU MLP
over ``x0`` beside them, and one linear layer over ``[x, deep]``."""

from __future__ import annotations

import torch

from . import embed as E
from .dlrm import mlp


def forward(params, dense, sparse, conf, tables=None):
    tables = params["tables"] if tables is None else tables
    feats = E.embed(tables, sparse, conf["embedding"]["op"])
    x0 = torch.cat([dense] + feats, dim=-1)
    x = x0
    for layer in params["cross"]:
        x = x0 * (x @ layer["w"])[:, None] + layer["b"] + x
    deep = mlp(params["deep"], x0, final_linear=False)
    return mlp(params["out"], torch.cat([x, deep], dim=-1), final_linear=True)[:, 0]

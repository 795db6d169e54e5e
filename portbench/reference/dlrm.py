"""DLRM (Naumov et al. 2019), plain: bottom MLP over the dense features,
the pairwise dots of ``[z; features]`` below the diagonal in row order
(``(1,0), (2,0), (2,1), …``), the top MLP over ``[z, dots]``, one logit.
Layers are ``x @ w + b`` with ReLU after every layer but the last."""

from __future__ import annotations

import torch

from . import embed as E


def mlp(layers, x, final_linear: bool):
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if not (final_linear and i == len(layers) - 1):
            x = torch.relu(x)
    return x


def interact(z: torch.Tensor, feats: list) -> torch.Tensor:
    x = torch.stack([z] + list(feats), dim=1)              # (B, F, D)
    f = x.shape[1]
    i, j = torch.tril_indices(f, f, offset=-1, device=x.device)
    dots = torch.bmm(x, x.transpose(1, 2))[:, i, j]
    return torch.cat([z, dots], dim=-1)


def forward(params, dense, sparse, conf, tables=None):
    """Logits ``(B,)``; ``tables`` replaces ``params["tables"]`` (the
    int8 tables the reference quantised itself)."""
    tables = params["tables"] if tables is None else tables
    feats = E.embed(tables, sparse, conf["embedding"]["op"])
    z = mlp(params["bottom"], dense, final_linear=False)
    return mlp(params["top"], interact(z, feats), final_linear=True)[:, 0]

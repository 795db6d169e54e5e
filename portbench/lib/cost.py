"""Operations and bytes of the models' stages, from their shapes.

FLOPs count two per multiply-add of every product the model needs: the
MLPs' matrix products, DLRM's pairwise dots, DCN's cross products
(``x · w`` and ``x0 · s``).  Bias adds, activations, the embedding
combine and the loss are left out.  Bytes count each input byte read
once and each output byte written once.
"""

from __future__ import annotations

import torch

F32 = 4
ID_BYTES = 4            # the stream's ids are int32


def mlp_macs(dims) -> int:
    return sum(i * o for i, o in zip(dims[:-1], dims[1:]))


def n_features(conf) -> int:
    """Features in DLRM's interaction: the bottom MLP's output and one per
    table."""
    return 1 + len(conf["table_sizes"])


def dlrm_forward_flops(conf) -> int:
    """FLOPs of DLRM's forward pass per sample."""
    d, f = conf["emb_dim"], n_features(conf)
    bottom = mlp_macs([conf["dense_dim"], *conf["bottom_mlp"], d])
    top_in = d + f * (f - 1) // 2
    top = mlp_macs([top_in, *conf["top_mlp"], 1])
    dots = f * (f - 1) // 2 * d
    return 2 * (bottom + top + dots)


def dcn_x0(conf) -> int:
    return conf["dense_dim"] + len(conf["table_sizes"]) * conf["emb_dim"]


def dcn_forward_flops(conf) -> int:
    """FLOPs of DCN's forward pass per sample."""
    d0 = dcn_x0(conf)
    cross = conf["cross_layers"] * 2 * d0
    deep = mlp_macs([d0, *conf["deep_mlp"]])
    out = d0 + conf["deep_mlp"][-1]
    return 2 * (cross + deep + out)


def interact_bytes(conf, n: int) -> int:
    """DLRM's interaction (K2): ``z (n, D)`` and the features ``(n, T, D)``
    in, the top MLP's input ``(n, D + F(F−1)/2)`` out, f32."""
    d, f = conf["emb_dim"], n_features(conf)
    return n * F32 * (d + (f - 1) * d + d + f * (f - 1) // 2)


def interact_flops(conf, n: int) -> int:
    f = n_features(conf)
    return n * 2 * (f * (f - 1) // 2) * conf["emb_dim"]


def row_bytes(dim: int, stored: str) -> int:
    """Bytes of one stored row: int8 rows carry a bf16 scale and an int8
    zero point."""
    return {"int8": dim + 3, "float32": F32 * dim}[stored]


def distinct_rows(sparse: torch.Tensor, table_rows: list) -> int:
    """Distinct live (table, row) pairs that ids ``sparse (n, T)`` read,
    each QR table as a remainder and a quotient table: ``table_rows[t]``
    is the remainder table's row count ``m`` (ids read rows ``x mod m`` and
    ``x div m``), or ``None`` for a full table read at ``x``."""
    ids = sparse.to(torch.int64)
    keys, offset = [], 0
    for t, m in enumerate(table_rows):
        col = ids[:, t]
        if m is None:
            keys.append(col + offset)
            offset += int(col.max()) + 1
        else:
            keys.append(torch.remainder(col, m) + offset)
            offset += m
            keys.append(torch.div(col, m, rounding_mode="floor") + offset)
            offset += int(col.max()) // m + 1
    return int(torch.unique(torch.cat(keys)).numel())


def embed_bytes(conf, sparse: torch.Tensor, table_rows: list, stored: str) -> int:
    """The one-hot embed stage of ``sparse (n, T)``: the ids, each distinct
    live row once at its stored width, and the ``(n, T, D)`` f32 output."""
    n, t = sparse.shape
    d = conf["emb_dim"]
    return (n * t * ID_BYTES + distinct_rows(sparse, table_rows) * row_bytes(d, stored)
            + n * t * d * F32)


def embed_flops(conf, n: int) -> int:
    """Per looked-up pair: the two rows dequantised (a subtract and a
    multiply per element each) and combined (one multiply per element)."""
    return n * len(conf["table_sizes"]) * conf["emb_dim"] * 5

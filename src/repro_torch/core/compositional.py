"""Operation-based compositional embeddings (paper §2, §4).

Frozen-dataclass configs with ``init(generator, device) -> params`` (a
dict of tensors) and ``apply(params, idx) -> embeddings``.  Every
``apply`` accepts an integer index tensor of any rank and returns
``idx.shape + (dim,)`` activations.

Pooled ("bag") lookups for multi-hot features sum masked rows; the fused
serving kernel in ``repro_torch.kernels`` implements the same contract.

``apply`` and ``bag_pool`` take a ``gather`` hook that replaces each
sub-table's local row fetch: the sharded serving path fetches rows that
live on other ranks through it (``dist.serve_placement.exchange_rows``),
through the same combine code as the local path.
"""

from __future__ import annotations

import dataclasses

import torch

from .partitions import Partition, qr_partitions

__all__ = [
    "FullEmbedding",
    "HashEmbedding",
    "CompositionalEmbedding",
    "qr_embedding",
    "bag_pool",
    "table_rows",
    "is_quantized_table",
]

OPS = ("mult", "add", "concat")


def _uniform(generator, shape, scale, dtype, device):
    """uniform(-scale, scale), drawn in f32 from ``generator`` and cast."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return (u * (2.0 * scale) - scale).to(dtype)


def is_quantized_table(leaf) -> bool:
    """The serving stack's row-quantized table format (the single
    predicate every consumer — gathers, kernels, byte accounting — uses)."""
    return isinstance(leaf, dict) and "q" in leaf and "scale" in leaf


def table_rows(table, idx):
    """Gather rows from a dense *or* row-quantized table.

    A quantized table is ``{"q": int8 (rows, D), "scale": bf16 (rows, 1),
    "zp": int8 (rows, 1)}`` (``repro_torch.serve.quantize``).  Only the
    gathered rows are dequantized (``(q - zp) * scale``, f32), so the
    full-precision table never materialises.
    """
    idx = torch.as_tensor(idx).long()
    if is_quantized_table(table):
        q = table["q"][idx].to(torch.float32)
        zp = table["zp"][idx].to(torch.float32)
        scale = table["scale"][idx].to(torch.float32)
        return (q - zp) * scale
    return table[idx]


def _gather(gather, table, idx, key):
    """Route one sub-table lookup through ``gather`` when given:
    ``gather(table_leaf, row_ids, sub_key) -> rows`` replaces the local
    ``table_rows``."""
    if gather is None:
        return table_rows(table, idx)
    return gather(table, idx, key)


@dataclasses.dataclass(frozen=True)
class FullEmbedding:
    """The baseline |S| x D table (paper Fig. 1 / 'Full')."""

    num_categories: int
    dim: int
    param_dtype: torch.dtype = torch.float32

    def init(self, generator, device="cuda"):
        scale = (1.0 / self.num_categories) ** 0.5
        return {"table": _uniform(generator, (self.num_categories, self.dim), scale,
                                  self.param_dtype, device)}

    def apply(self, params, idx, gather=None):
        return _gather(gather, params["table"], idx, "table")

    @property
    def num_params(self) -> int:
        return self.num_categories * self.dim

    @property
    def out_dim(self) -> int:
        return self.dim


@dataclasses.dataclass(frozen=True)
class HashEmbedding:
    """Hashing trick (paper Alg. 1): ``x -> table[x mod m]`` — lossy baseline."""

    num_categories: int
    dim: int
    m: int = 1
    param_dtype: torch.dtype = torch.float32

    def init(self, generator, device="cuda"):
        scale = (1.0 / self.num_categories) ** 0.5
        return {"table": _uniform(generator, (self.m, self.dim), scale,
                                  self.param_dtype, device)}

    def apply(self, params, idx, gather=None):
        return _gather(gather, params["table"], torch.as_tensor(idx) % self.m, "table")

    @property
    def num_params(self) -> int:
        return self.m * self.dim

    @property
    def out_dim(self) -> int:
        return self.dim


@dataclasses.dataclass(frozen=True)
class CompositionalEmbedding:
    """Operation-based compositional embedding over complementary partitions.

    One table per partition (rows = that partition's bucket count); per-index
    rows are combined with ``op`` in {mult, add, concat} (paper eq. 6).  With
    the QR pair this is exactly Algorithm 2.  ``dims`` gives each table's
    embedding width: for mult/add all must equal ``dim``; for concat they
    must sum to ``dim`` (defaults to an even split).
    """

    num_categories: int
    dim: int
    partitions: tuple[Partition, ...] = ()
    op: str = "mult"
    dims: tuple[int, ...] = ()
    param_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"op={self.op!r} not in {OPS}")
        if not self.partitions:
            raise ValueError("need at least one partition")
        k = len(self.partitions)
        if not self.dims:
            if self.op == "concat":
                base = self.dim // k
                dims = [base] * k
                dims[-1] += self.dim - base * k
            else:
                dims = [self.dim] * k
            object.__setattr__(self, "dims", tuple(dims))
        if self.op == "concat":
            if sum(self.dims) != self.dim:
                raise ValueError(f"concat dims {self.dims} must sum to {self.dim}")
        elif any(d != self.dim for d in self.dims):
            raise ValueError(f"{self.op} requires all dims == {self.dim}, got {self.dims}")

    def init(self, generator, device="cuda"):
        # Every table is drawn uniform(-sqrt(1/|S|), sqrt(1/|S|)) as in the
        # reference DLRM QR implementation; for `mult` the product of k such
        # rows would have scale |S|^{-k/2}, so each table takes the k-th root
        # and the *combined* embedding matches the full table's scale.
        scale = (1.0 / self.num_categories) ** 0.5
        if self.op == "mult":
            scale = scale ** (1.0 / len(self.partitions))
        return {
            f"table_{j}": _uniform(generator, (p.num_buckets, d), scale,
                                   self.param_dtype, device)
            for j, (p, d) in enumerate(zip(self.partitions, self.dims))
        }

    def partition_embeddings(self, params, idx, gather=None):
        """Per-partition rows (the 'feature generation' mode, paper §4)."""
        idx = torch.as_tensor(idx)
        return [_gather(gather, params[f"table_{j}"], p.bucket(idx), f"table_{j}")
                for j, p in enumerate(self.partitions)]

    def apply(self, params, idx, gather=None):
        zs = self.partition_embeddings(params, idx, gather=gather)
        if self.op == "concat":
            return torch.cat(zs, dim=-1)
        if self.op == "add":
            return sum(zs[1:], zs[0])
        out = zs[0]
        for z in zs[1:]:
            out = out * z
        return out

    @property
    def num_params(self) -> int:
        return sum(p.num_buckets * d for p, d in zip(self.partitions, self.dims))

    @property
    def out_dim(self) -> int:
        return self.dim


def qr_embedding(
    num_categories: int,
    dim: int,
    num_collisions: int = 4,
    op: str = "mult",
    param_dtype: torch.dtype = torch.float32,
) -> CompositionalEmbedding:
    """Quotient–remainder trick (paper Alg. 2) with the paper's knob.

    ``num_collisions`` c gives a remainder table of ``m = ceil(|S|/c)`` rows
    and a quotient table of ``c`` rows — an ~c× parameter reduction.
    """
    m = max(1, -(-num_categories // max(1, num_collisions)))
    return CompositionalEmbedding(
        num_categories=num_categories,
        dim=dim,
        partitions=tuple(qr_partitions(num_categories, m)),
        op=op,
        param_dtype=param_dtype,
    )


def bag_pool(module, params, idx, mask=None, gather=None):
    """Sum-pooled multi-hot lookup: ``sum_l emb(idx[..., l]) * mask[..., l]``.

    ``idx``: int tensor ``(..., L)``; ``mask``: optional ``(..., L)`` (1 keeps
    the row).  Returns ``(..., dim)`` in the row dtype.  ``gather``
    substitutes the row fetch (``_gather``); a module whose ``apply`` takes
    no hook (path-based tables) refuses one, as the reference's does.
    """
    emb = module.apply(params, idx) if gather is None \
        else module.apply(params, idx, gather=gather)  # (..., L, D)
    # pool in f32, round once: a bf16 running sum would round every one
    # of the L adds
    pooled = emb.to(torch.float32)
    if mask is not None:
        pooled = pooled * mask[..., None].to(torch.float32)
    return torch.sum(pooled, dim=-2, dtype=torch.float32).to(emb.dtype)

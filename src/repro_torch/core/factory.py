"""Config-driven embedding construction, including the paper's thresholding.

``EmbeddingSpec`` is the single knob surface exposed through model configs.
The factory applies the paper's §5.4 thresholding rule: tables with at most
``threshold`` categories keep a full table; only larger tables are
compressed.

The from-plan path: ``spec`` may also be a ``repro_torch.plan.MemoryPlan``
(duck-typed via ``spec_for`` — no import cycle), in which case ``feature``
selects the per-feature spec the planner solved for; the plan validates
cardinality and embedding dim so a stale plan fails loudly instead of
silently building un-scored tables.  Mixed-dimension plans additionally
carry a per-feature table width (``plan.dim_for``): the module is built
at that width (its ``out_dim`` reports it), and the models project each
feature back to the interaction width ``dim``.
"""

from __future__ import annotations

import dataclasses

import torch

from .compositional import CompositionalEmbedding, FullEmbedding, HashEmbedding, qr_embedding
from .partitions import crt_partitions, generalized_qr_partitions, qr_partitions
from .path import PathBasedEmbedding

__all__ = ["EmbeddingSpec", "make_embedding"]

KINDS = ("full", "hash", "qr", "mixed_radix", "crt", "path", "feature")


@dataclasses.dataclass(frozen=True)
class EmbeddingSpec:
    kind: str = "full"
    num_collisions: int = 4     # paper's compression knob (≈ model-size reduction factor)
    op: str = "mult"            # mult | add | concat  (paper §4 operations)
    threshold: int = 0          # tables with <= threshold rows stay full (paper §5.4)
    ms: tuple[int, ...] = ()    # explicit radices/moduli for mixed_radix / crt
    path_hidden: int = 64       # paper table 1/2 MLP width

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"kind={self.kind!r} not in {KINDS}")


def make_embedding(num_categories: int, dim: int, spec: EmbeddingSpec,
                   param_dtype=torch.float32, feature: int | None = None):
    """Build the embedding module for one categorical feature/table.

    ``spec`` is an ``EmbeddingSpec`` or a ``repro_torch.plan.MemoryPlan``; a
    plan requires ``feature`` (the categorical feature index) to pick the
    table choice the planner made for it.  Building allocates nothing: the
    module's ``init`` draws its tables.
    """
    if hasattr(spec, "spec_for"):  # MemoryPlan: resolve the per-feature spec
        if feature is None:
            raise ValueError("building from a MemoryPlan requires feature=<i> "
                             "(the categorical feature index)")
        plan = spec
        spec = plan.spec_for(feature, num_categories=num_categories, dim=dim)
        width = plan.dim_for(feature) if hasattr(plan, "dim_for") else dim
        if not 1 <= width <= dim:
            raise ValueError(f"plan table {feature} has width {width} outside "
                             f"[1, emb_dim={dim}] — regenerate the plan")
        dim = width
    if spec.kind == "full" or num_categories <= max(spec.threshold, 1):
        return FullEmbedding(num_categories, dim, param_dtype)
    c = max(1, spec.num_collisions)
    m = -(-num_categories // c)  # remainder-table rows
    if spec.kind == "hash":
        return HashEmbedding(num_categories, dim, m=m, param_dtype=param_dtype)
    if spec.kind in ("qr", "feature"):
        # `feature` reuses the QR tables; models call partition_embeddings()
        # instead of apply() to treat each partition as its own sparse feature.
        return qr_embedding(num_categories, dim, num_collisions=c, op=spec.op,
                            param_dtype=param_dtype)
    if spec.kind == "mixed_radix":
        ms = spec.ms or _balanced_radices(num_categories, 3)
        return CompositionalEmbedding(
            num_categories, dim,
            partitions=tuple(generalized_qr_partitions(num_categories, ms)),
            op=spec.op, param_dtype=param_dtype)
    if spec.kind == "crt":
        if not spec.ms:
            raise ValueError("crt requires explicit pairwise-coprime spec.ms")
        return CompositionalEmbedding(
            num_categories, dim,
            partitions=tuple(crt_partitions(num_categories, spec.ms)),
            op=spec.op, param_dtype=param_dtype)
    if spec.kind == "path":
        return PathBasedEmbedding(
            num_categories, dim,
            partitions=tuple(qr_partitions(num_categories, m)),
            hidden=spec.path_hidden, param_dtype=param_dtype)
    raise AssertionError(spec.kind)


def _balanced_radices(size: int, k: int) -> tuple[int, ...]:
    """k near-equal radices with product >= size (optimal O(k·size^{1/k}·D))."""
    base = int(round(size ** (1.0 / k)))
    while True:
        ms = [base] * (k - 1)
        last = -(-size // max(1, base ** (k - 1)))
        ms.append(max(last, 1))
        prod = 1
        for m in ms:
            prod *= m
        if prod >= size:
            return tuple(ms)
        base += 1

"""Candidate embedding configurations per feature.

Every candidate is an ``EmbeddingSpec`` the factory already understands —
enumeration *builds the module through* the port's
``core.factory.make_embedding`` and reads rows / partitions off the
result, so the planner's cost and quality models are definitionally
consistent with what training will instantiate (the
plan→``make_embedding``→``num_params`` round-trip test pins this).  A
module is a frozen description: building one allocates no table, so a
full 10.1 M-row candidate costs what its structure costs to build.

Families enumerated per feature of cardinality ``n``:

* ``full``        — the |S|·D anchor (quality 1);
* ``hash``        — remainder-only at collision factors ``c`` (rows
  ``ceil(n/c)``): the lossy baseline ladder, and the only family that can
  go arbitrarily small (down to one row), so every budget is feasible;
* ``qr``          — quotient–remainder pairs at the same ladder (rows
  ``ceil(n/c) + c``-ish, paper Alg. 2);
* ``mixed_radix`` — generalized QR at k balanced radices (rows
  ``~k·n^(1/k)``, the cheapest complementary family).

Costs are reported in two byte domains sharing one accounting, summed
over the module's *physical* sub-tables ``(rows_j, width_j)`` (exact for
``op="concat"``, where sub-table widths are ``dim/k``):

* ``train_bytes``      — Σ rows_j · width_j · 4 (f32 training tables);
* ``serve_bytes_int8`` — Σ rows_j · ``row_bytes(width_j, "int8")`` (the
  width+3 B/row post-training-quantized wire format) — the serve-time
  budget domain.

**Mixed dimensions**: pass ``dims=dim_ladder(D)`` ({D/4, D/2, D}) to
cross-product every spec with a width axis — each candidate is then built
at its own ``dim`` and scored with the dim-aware proxy
(``quality.dim_proxy_quality``), and the solver folds the cross-product
into the same per-feature convex-hull frontier (still exact MCKP).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.factory import EmbeddingSpec, _balanced_radices, make_embedding
from ..serve.quantize import row_bytes
from .freq import FeatureStats
from .quality import dim_proxy_quality, module_partitions

__all__ = ["Candidate", "enumerate_candidates", "HASH_LADDER", "QR_LADDER",
           "MIXED_RADIX_KS", "candidate_specs", "candidate_for",
           "module_tables", "bytes_per_row", "BYTE_DOMAINS", "dim_ladder"]

BYTE_DOMAINS = ("train_f32", "serve_int8")


def bytes_per_row(dim: int, domain: str) -> int:
    """Bytes per ``dim``-wide table row in a solve domain — the single
    domain→cost mapping the candidate ladder, the solver's cost function,
    and ``planner.full_table_bytes`` all share (a new domain, e.g. 4-bit
    tables, is added here once)."""
    if domain == "train_f32":
        return 4 * dim
    if domain == "serve_int8":
        return row_bytes(dim, "int8")
    raise ValueError(f"unknown byte domain {domain!r}; "
                     f"expected one of {BYTE_DOMAINS}")

HASH_LADDER = (2, 4, 8, 16, 32, 64, 128, 256, 1024)
QR_LADDER = (2, 4, 8, 16, 32, 64, 128)
MIXED_RADIX_KS = (2, 3)


def dim_ladder(full_dim: int) -> tuple[int, ...]:
    """The default mixed-dimension width ladder {D/4, D/2, D} — the second
    knapsack axis the planner cross-products with the structural specs."""
    return tuple(sorted({max(1, full_dim // 4), max(1, full_dim // 2),
                         full_dim}))


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One scored configuration of one feature's table.

    ``rows`` and both byte costs are derived from the *physical* tables
    the factory builds (``(rows_j, width_j)`` per partition), so they stay
    exact for ``op="concat"`` where sub-table widths are ``dim/k`` and
    ``num_params`` is not a multiple of ``dim``.  ``dim`` is the table's
    *embedding width* — mixed-dimension plans carry a per-feature dim and
    the models project back to the interaction width.
    """

    feature: int
    num_categories: int
    spec: EmbeddingSpec
    rows: int                 # total physical rows across sub-tables
    train_bytes: int          # f32 training bytes: sum rows_j * width_j * 4
    serve_bytes_int8: int     # sum rows_j * row_bytes(width_j, "int8")
    quality: float
    dim: int = 0              # embedding width this candidate was built at

    @property
    def label(self) -> str:
        s = self.spec
        if s.kind in ("hash", "qr"):
            base = f"{s.kind}/c{s.num_collisions}"
        elif s.kind == "mixed_radix":
            base = f"mr/{'x'.join(map(str, s.ms))}"
        else:
            base = s.kind
        return f"{base}@d{self.dim}" if self.dim else base

    def bytes(self, domain: str = "train_f32") -> int:
        if domain == "train_f32":
            return self.train_bytes
        if domain == "serve_int8":
            return self.serve_bytes_int8
        raise ValueError(f"unknown byte domain {domain!r}")


def module_tables(module) -> list[tuple[int, int]]:
    """Physical ``(rows, width)`` per sub-table — the ground truth both
    byte domains cost against (``sum(r*w) == module.num_params``)."""
    from ..core.compositional import (CompositionalEmbedding, FullEmbedding,
                                      HashEmbedding)
    if isinstance(module, CompositionalEmbedding):
        return [(p.num_buckets, d)
                for p, d in zip(module.partitions, module.dims)]
    if isinstance(module, HashEmbedding):
        return [(module.m, module.dim)]
    if isinstance(module, FullEmbedding):
        return [(module.num_categories, module.dim)]
    raise TypeError(f"no table view for module {type(module).__name__}")


def candidate_for(feature: int, stats: FeatureStats, dim: int,
                  spec: EmbeddingSpec, param_dtype=torch.float32,
                  full_dim: int | None = None) -> Candidate:
    """Build + score one spec through the factory (the single source of
    structure for cost, quality, and the eventual model).  ``dim`` is the
    width the table is built at; ``full_dim`` (default ``dim``) is the
    model's interaction width the dim-aware proxy scores against."""
    module = make_embedding(stats.size, dim, spec, param_dtype)
    tables = module_tables(module)
    assert sum(r * w for r, w in tables) == module.num_params
    return Candidate(
        feature=feature, num_categories=stats.size, spec=spec,
        rows=sum(r for r, _ in tables),
        train_bytes=sum(r * w * 4 for r, w in tables),
        serve_bytes_int8=sum(r * row_bytes(w, "int8") for r, w in tables),
        quality=dim_proxy_quality(module_partitions(module), stats,
                                  dim, full_dim or dim),
        dim=dim)


def candidate_specs(n: int, *, op: str = "mult",
                    hash_ladder=HASH_LADDER, qr_ladder=QR_LADDER,
                    mixed_radix_ks=MIXED_RADIX_KS) -> list[EmbeddingSpec]:
    """The raw spec ladder for a feature of cardinality ``n`` (pre-scoring)."""
    specs = [EmbeddingSpec(kind="full")]
    for c in hash_ladder:
        if c >= 2 and -(-n // c) < n:
            specs.append(EmbeddingSpec(kind="hash", num_collisions=c))
    for c in qr_ladder:
        if c >= 2 and c < n:
            specs.append(EmbeddingSpec(kind="qr", num_collisions=c, op=op))
    for k in mixed_radix_ks:
        if n >= 2 ** k:  # k digits need at least 2 values each
            specs.append(EmbeddingSpec(kind="mixed_radix",
                                       ms=_balanced_radices(n, k), op=op))
    return specs


def enumerate_candidates(feature: int, stats: FeatureStats, dim: int, *,
                         op: str = "mult", param_dtype=torch.float32,
                         extra_specs=(),
                         bytes_domain: str = "train_f32",
                         dims: tuple[int, ...] | None = None
                         ) -> list[Candidate]:
    """Score the spec ladder for one feature, deduplicated by cost in the
    *solve domain* (keep the best quality per distinct cost; drop configs
    costlier than full — two specs can tie on train bytes yet differ on
    serve-int8 bytes, so the dedup key must match the budget's domain).
    Always contains at least the one-row hash, so any global budget
    >= F·D·4 bytes is satisfiable.

    ``dims`` is the width axis: every spec is enumerated at every width
    (default: ``(dim,)`` — the uniform-width ladder, byte-identical to the
    pre-dim planner).  ``dim`` stays the model's interaction width the
    dim-aware proxy scores against; a full-width full table is the only
    quality-1 anchor, so the `full@D` cost cap applies across widths."""
    n = stats.size
    widths = tuple(dims) if dims else (dim,)
    if any(w < 1 or w > dim for w in widths):
        raise ValueError(f"candidate widths {widths} must be in [1, {dim}]")
    full_cost = n * bytes_per_row(dim, bytes_domain)
    by_cost: dict[int, Candidate] = {}

    def admit(spec, width):
        cand = candidate_for(feature, stats, width, spec, param_dtype,
                             full_dim=dim)
        cost = cand.bytes(bytes_domain)
        if cost >= full_cost and not (spec.kind == "full" and width == dim):
            return  # costs at least the full@D table: dominated
        best = by_cost.get(cost)
        if best is None or cand.quality > best.quality:
            by_cost[cost] = cand

    for width in widths:
        for spec in list(candidate_specs(n, op=op)) + list(extra_specs):
            admit(spec, width)
    # guarantee a floor candidate (hash down to 1 row) for feasibility
    if min(c.rows * c.dim for c in by_cost.values()) > min(widths):
        admit(EmbeddingSpec(kind="hash", num_collisions=max(2, n)),
              min(widths))
    return [by_cost[b] for b in sorted(by_cost)]

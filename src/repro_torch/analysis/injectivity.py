"""Layer-2 partition-injectivity certifier: prove every ``MemoryPlan``
table spec is a complementary partition family (paper Def. 1) — the
JAX package's ``analysis/injectivity.py`` over the port's partitions,
factory, quality module and planner.

The planner's entire quality claim rests on compositional tables being
*lossless* codes: the tuple ``x -> (p_1(x), ..., p_k(x))`` must be
injective on ``{0..size-1}``.  The constructors enforce this by raising,
but a plan is a JSON artifact — hand-edited, migrated, or emitted by a
future solver — so the analyzer re-proves it from the artifact alone:

* **exactly**, from structure, for every family the factory builds —
  mixed-radix digit maps (cumulative divisors + ``prod(ms) >= size``),
  quotient/remainder pairs (``x = (x//m)·m + x%m``), CRT remainder sets
  (pairwise coprime + product bound), single tables (pigeonhole both
  directions);
* by brute force (``is_complementary``) for explicit/unrecognized
  families up to ``COMPLEMENTARY_CHECK_MAX`` ids;
* by seeded sampling above that — a found collision is still an exact
  counterexample; a clean sample is reported as *inexact* evidence.

``hash`` tables are lossy by design and never produce a finding; every
other kind must certify injective.  The pass certifies (a) a mini
budget sweep mirroring ``plan_bench`` (both archs x 4 budget fractions,
uniform and mixed-dimension) and (b) every plan JSON under
``artifacts/plans/`` plus any ``--plan`` paths (the plan JSON schema is
shared with the JAX package, so either package's plans certify here).
"""

from __future__ import annotations

import dataclasses
import glob
import math
import os
from functools import reduce
from typing import Sequence

from ..plan.quality import COMPLEMENTARY_CHECK_MAX  # the brute-force cap
from .findings import Finding
from .registry import Context, register_pass

__all__ = ["Certificate", "certify_partitions", "certify_table",
           "certify_plan", "sweep_plans", "COMPLEMENTARY_CHECK_MAX"]

_RULE = "INJ-001"

_SAMPLE = 4096


@dataclasses.dataclass(frozen=True)
class Certificate:
    """Outcome of one injectivity proof attempt."""

    injective: bool
    exact: bool       # False only for the no-collision-found sample path
    method: str       # mixed-radix | quotient-remainder | crt | pigeonhole
                      # | brute-force | sampled | empty
    detail: str = ""

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _prod(xs) -> int:
    return reduce(lambda a, b: a * b, xs, 1)


def _sampled(partitions, size: int) -> Certificate:
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    ids = np.unique(np.concatenate([
        rng.integers(0, size, _SAMPLE),
        np.arange(min(size, 64)),                  # dense low end
        size - 1 - np.arange(min(size, 64)),       # dense high end
    ]))
    codes = np.stack([p.bucket(torch.as_tensor(ids)).numpy()
                      for p in partitions], axis=-1)
    uniq = len(np.unique(codes, axis=0))
    if uniq < len(ids):
        return Certificate(False, True, "sampled",
                           f"collision among {len(ids)} sampled ids — "
                           "exact counterexample")
    return Certificate(True, False, "sampled",
                       f"no collision in {len(ids)} sampled ids "
                       f"(size={size} exceeds brute cap)")


def certify_partitions(partitions: Sequence, size: int) -> Certificate:
    """Prove or refute injectivity of the code tuple on {0..size-1}."""
    from ..core.partitions import (GeneralizedQRPartition,
                                   QuotientPartition, RemainderPartition,
                                   is_complementary)
    parts = list(partitions)
    if size <= 1:
        return Certificate(True, True, "empty", "at most one category")
    if not parts:
        return Certificate(False, True, "empty", "no partitions")

    # pigeonhole: fewer code tuples than categories — exact, any family
    total = _prod(p.num_buckets for p in parts)
    if total < size:
        return Certificate(False, True, "pigeonhole",
                           f"prod(num_buckets)={total} < size={size}")

    if all(isinstance(p, GeneralizedQRPartition) for p in parts):
        digits = sorted(parts, key=lambda p: p.divisor)
        divisor = 1
        for p in digits:
            if p.divisor != divisor:
                break
            divisor *= p.modulus
        else:
            # x -> mixed-radix digits is a bijection below prod(ms),
            # and size <= prod(ms) held above
            return Certificate(True, True, "mixed-radix",
                               f"radices {[p.modulus for p in digits]}, "
                               f"prod={divisor} >= size={size}")

    if (len(parts) == 2
            and {type(p) for p in parts}
            == {RemainderPartition, QuotientPartition}
            and len({p.m for p in parts}) == 1):
        m = parts[0].m
        return Certificate(True, True, "quotient-remainder",
                           f"x = (x // {m}) * {m} + x %% {m}")

    if all(isinstance(p, RemainderPartition) for p in parts):
        ms = [p.m for p in parts]
        coprime = all(math.gcd(ms[i], ms[j]) == 1
                      for i in range(len(ms))
                      for j in range(i + 1, len(ms)))
        if coprime:
            # CRT: x mod prod(ms) is determined by the residues, and
            # size <= prod(ms) held above
            return Certificate(True, True, "crt",
                               f"pairwise-coprime moduli {ms}, "
                               f"prod >= size={size}")

    if size <= COMPLEMENTARY_CHECK_MAX:
        ok = is_complementary(parts, size)
        return Certificate(bool(ok), True, "brute-force",
                           f"all {size} code tuples enumerated")
    return _sampled(parts, size)


def _structural_partitions(table) -> list:
    """Partition family implied by a TablePlan's fields, built without
    the raising constructors — a corrupt artifact must *report* as
    non-injective, not crash the certifier."""
    from ..core.factory import _balanced_radices
    from ..core.partitions import (GeneralizedQRPartition,
                                   QuotientPartition, RemainderPartition,
                                   naive_partition)
    size, spec = table.num_categories, table.spec()
    if spec.kind == "full" or size <= max(spec.threshold, 1):
        return list(naive_partition(size))
    c = max(1, spec.num_collisions)
    m = -(-size // c)
    if spec.kind == "hash":
        return [RemainderPartition(size=size, num_buckets=m, m=m)]
    if spec.kind in ("qr", "feature"):
        q = math.ceil(size / m)
        return [RemainderPartition(size=size, num_buckets=m, m=m),
                QuotientPartition(size=size, num_buckets=q, m=m)]
    if spec.kind == "mixed_radix":
        ms = list(spec.ms) or list(_balanced_radices(size, 3))
        parts, divisor = [], 1
        for radix in ms:
            parts.append(GeneralizedQRPartition(
                size=size, num_buckets=radix, divisor=divisor,
                modulus=radix))
            divisor *= radix
        return parts
    if spec.kind == "crt":
        return [RemainderPartition(size=size, num_buckets=radix, m=radix)
                for radix in spec.ms]
    raise ValueError(f"unknown table kind {spec.kind!r}")


def certify_table(table, emb_dim: int) -> tuple[bool, Certificate, str]:
    """(must_be_injective, certificate, partition_source) for one table.

    Prefers the factory's ``module_partitions`` ground truth (the exact
    structure the built model uses); falls back to the structural view
    when the constructors refuse the spec — which is precisely the
    corrupt-artifact case the certifier exists to report.
    """
    from ..core.factory import make_embedding
    from ..plan.quality import module_partitions
    size = table.num_categories
    spec = table.spec()
    # hash is the paper's lossy baseline: collisions are the point
    lossy_ok = spec.kind == "hash" and size > max(spec.threshold, 1)
    try:
        module = make_embedding(size, table.dim or emb_dim, spec)
        parts, source = module_partitions(module), "factory"
    except Exception as e:
        parts, source = _structural_partitions(table), f"structural ({e!r})"
    return (not lossy_ok, certify_partitions(parts, size), source)


def certify_plan(plan, anchor: str) -> tuple[list[Finding], dict]:
    """Certify every table of one MemoryPlan; returns (findings, row)."""
    findings: list[Finding] = []
    certs = []
    for t in plan.tables:
        try:
            required, cert, source = certify_table(t, plan.emb_dim)
        except Exception as e:
            findings.append(Finding(
                rule=_RULE, path=anchor, line=0, layer=2,
                message=f"table {t.feature} ({t.kind}, "
                        f"{t.num_categories} categories) could not be "
                        f"certified: {e!r}"))
            continue
        certs.append({"feature": t.feature, "kind": t.kind,
                      "size": t.num_categories, "required": required,
                      "source": source, **cert.as_dict()})
        if required and not cert.injective:
            findings.append(Finding(
                rule=_RULE, path=anchor, line=0, layer=2,
                message=f"table {t.feature} ({t.kind}, ms={list(t.ms)}, "
                        f"{t.num_categories} categories) is NOT a "
                        f"complementary partition: {cert.method} — "
                        f"{cert.detail}"))
    row = {"plan": anchor, "arch": plan.arch,
           "tables": len(plan.tables),
           "exact": sum(c["exact"] for c in certs),
           "findings": len(findings), "certificates": certs}
    return findings, row


def sweep_plans(stats_batches: int = 6, batch_size: int = 256):
    """The plan_bench budget sweep in miniature: both archs, all four
    budget fractions, uniform-width and mixed-dimension."""
    from ..configs import get_arch
    from ..data.criteo import CriteoSpec
    from ..plan import (build_plan, dim_ladder, full_table_bytes,
                        stats_from_criteo)
    for arch in ("dlrm-criteo", "dcn-criteo"):
        cfg = get_arch(arch).config(reduced=True)
        spec = CriteoSpec(table_sizes=cfg.table_sizes, zipf=1.5, noise=0.5)
        stats = stats_from_criteo(spec, num_batches=stats_batches,
                                  batch_size=batch_size)
        dim = cfg.emb_dim
        full = full_table_bytes(cfg.table_sizes, dim)
        for frac in (0.05, 0.125, 0.25, 0.5):
            budget = int(full * frac)
            yield (f"analysis://plan/{arch}@{frac}x",
                   build_plan(stats, dim, budget, arch=arch))
            yield (f"analysis://plan/{arch}-mixed@{frac}x",
                   build_plan(stats, dim, budget, arch=f"{arch}-mixed",
                              dims=dim_ladder(dim)))


@register_pass(_RULE, "partition-injectivity", 2,
               "every MemoryPlan table spec certifies as a complementary "
               "partition (exact structural proof where possible)")
def injectivity_pass(ctx: Context) -> list[Finding]:
    from ..plan.memory_plan import MemoryPlan
    findings: list[Finding] = []
    rows = []
    for anchor, plan in sweep_plans():
        fs, row = certify_plan(plan, anchor)
        findings += fs
        rows.append(row)
    paths = list(ctx.plan_paths or ())
    paths += sorted(glob.glob(os.path.join(ctx.root, "artifacts", "plans",
                                           "*.json")))
    seen = set()
    for path in paths:
        rel = os.path.relpath(path, ctx.root)
        if rel in seen:
            continue
        seen.add(rel)
        try:
            plan = MemoryPlan.load(path)
        except Exception as e:
            findings.append(Finding(
                rule=_RULE, path=rel, line=0, layer=2,
                message=f"plan artifact failed to load: {e!r}"))
            continue
        fs, row = certify_plan(plan, rel)
        findings += fs
        rows.append(row)
    total = sum(r["tables"] for r in rows)
    exact = sum(r["exact"] for r in rows)
    ctx.notes[_RULE] = {"plans": rows, "tables_certified": total,
                        "exact_certificates": exact}
    return findings

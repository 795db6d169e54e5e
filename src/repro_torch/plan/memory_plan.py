"""The serializable ``MemoryPlan`` artifact — one machine-generated answer
to "where do the embedding bytes go".

A plan is a list of per-feature table choices plus the bookkeeping that
makes it auditable: budget and domain it was solved under, achieved
bytes, proxy quality vs the uniform-hashing baseline, and per-table
diagnostics (partition row counts, bucket entropies, complementarity).
It is a plain JSON file under ``artifacts/plans/`` so training, serving,
and benches all consume the identical decision.

Executability contract: ``spec_for(feature)`` returns the exact
``EmbeddingSpec`` the factory builds from — ``core.factory.make_embedding``
accepts a plan directly (the from-plan path), and the round-trip
plan → JSON → ``make_embedding`` → ``num_params`` is byte-stable (tested).

The JSON schema is the JAX package's: a plan written by either package
loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os

from ..core.factory import EmbeddingSpec

__all__ = ["TablePlan", "MemoryPlan", "PLAN_DIR", "plan_path", "plan_differences"]

PLAN_DIR = os.path.join("artifacts", "plans")
SCHEMA_VERSION = 1


def plan_path(arch: str, budget_bytes: int, base: str = PLAN_DIR) -> str:
    mb = budget_bytes / 2 ** 20
    return os.path.join(base, f"{arch}_{mb:g}mb.json")


@dataclasses.dataclass(frozen=True)
class TablePlan:
    """The chosen configuration of one categorical feature's table."""

    feature: int
    num_categories: int
    kind: str                       # full | hash | qr | mixed_radix
    num_collisions: int = 4
    ms: tuple[int, ...] = ()
    op: str = "mult"
    rows: int = 0
    train_bytes: int = 0
    serve_bytes_int8: int = 0
    quality: float = 1.0
    entropies: tuple[float, ...] = ()
    complementary: bool | None = None   # None: by-theorem, not brute-checked
    dim: int = 0                    # table width; 0 = the plan's emb_dim

    def spec(self) -> EmbeddingSpec:
        return EmbeddingSpec(kind=self.kind, num_collisions=self.num_collisions,
                             ms=tuple(self.ms), op=self.op)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["ms"] = list(self.ms)
        d["entropies"] = list(self.entropies)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TablePlan":
        d = dict(d)
        d["ms"] = tuple(d.get("ms", ()))
        d["entropies"] = tuple(d.get("entropies", ()))
        return cls(**d)


@dataclasses.dataclass
class MemoryPlan:
    """A solved byte allocation across every categorical feature."""

    arch: str
    emb_dim: int
    budget_bytes: int
    bytes_domain: str               # train_f32 | serve_int8
    total_bytes: int                # achieved, in the budget domain
    full_bytes: int                 # the all-full-table cost, same domain
    quality: float                  # mean per-feature proxy quality
    baseline_quality: float         # uniform hashing at the same budget
    tables: list[TablePlan] = dataclasses.field(default_factory=list)
    # solver bookkeeping (parked upgrades, hull drops, leftover bytes —
    # the "no silent caps" audit trail); free-form JSON-safe dict.
    notes: dict = dataclasses.field(default_factory=dict)

    # models ask ``cfg.embedding.kind`` to detect feature-generation mode;
    # a plan is never that, so it reports its own kind.
    @property
    def kind(self) -> str:
        return "plan"

    @property
    def table_sizes(self) -> tuple[int, ...]:
        return tuple(t.num_categories for t in self.tables)

    def spec_for(self, feature: int, num_categories: int | None = None,
                 dim: int | None = None) -> EmbeddingSpec:
        """The per-feature EmbeddingSpec — the factory's from-plan hook.

        Validates that the caller's geometry matches what the plan was
        solved for; a silent mismatch would build a model the planner
        never scored.
        """
        if not 0 <= feature < len(self.tables):
            raise ValueError(f"plan for {self.arch!r} has "
                             f"{len(self.tables)} tables, no feature {feature}")
        t = self.tables[feature]
        if num_categories is not None and num_categories != t.num_categories:
            raise ValueError(
                f"plan table {feature} was solved for {t.num_categories} "
                f"categories, model has {num_categories} — regenerate the plan")
        if dim is not None and dim != self.emb_dim:
            raise ValueError(f"plan was solved at emb_dim={self.emb_dim}, "
                             f"model uses {dim} — regenerate the plan")
        return t.spec()

    def dim_for(self, feature: int) -> int:
        """The planned table width of ``feature`` — ``emb_dim`` unless the
        planner chose a reduced (mixed-dimension) width.  The factory
        builds the table at this width; the models project back to
        ``emb_dim`` for the interaction."""
        if not 0 <= feature < len(self.tables):
            raise ValueError(f"plan for {self.arch!r} has "
                             f"{len(self.tables)} tables, no feature {feature}")
        return self.tables[feature].dim or self.emb_dim

    @property
    def table_dims(self) -> tuple[int, ...]:
        return tuple(self.dim_for(i) for i in range(len(self.tables)))

    def validate_sizes(self, table_sizes) -> None:
        if tuple(table_sizes) != self.table_sizes:
            raise ValueError(
                f"plan table sizes {self.table_sizes} do not match the "
                f"config's {tuple(table_sizes)} — regenerate the plan")

    def summary(self) -> dict:
        kinds: dict[str, int] = {}
        dims: dict[int, int] = {}
        for t in self.tables:
            kinds[t.kind] = kinds.get(t.kind, 0) + 1
            d = t.dim or self.emb_dim
            dims[d] = dims.get(d, 0) + 1
        return {"arch": self.arch, "emb_dim": self.emb_dim,
                "bytes_domain": self.bytes_domain,
                "budget_bytes": self.budget_bytes,
                "total_bytes": self.total_bytes,
                "budget_frac_of_full": self.total_bytes / self.full_bytes
                if self.full_bytes else 0.0,
                "quality": self.quality,
                "baseline_quality": self.baseline_quality,
                "kinds": kinds, "dims": {str(k): v for k, v
                                         in sorted(dims.items())},
                "parked": len(self.notes.get("parked", []))}

    def annotate_placement(self, placement) -> None:
        """Record a serving placement (``dist.serve_placement.
        ServePlacement``) in the plan's notes so the JSON artifact carries
        where each sub-table lives on the serving mesh — round-trips
        through ``to_json``/``from_json`` like every note."""
        self.notes["serve_placement"] = placement.as_dict()

    def serve_placement(self):
        """The annotated serving placement (written by either package), or
        ``None``."""
        d = self.notes.get("serve_placement")
        if d is None:
            return None
        from ..dist.serve_placement import ServePlacement
        return ServePlacement.from_dict(d)

    def to_json(self) -> str:
        return json.dumps(
            {"schema": SCHEMA_VERSION, "arch": self.arch,
             "emb_dim": self.emb_dim, "budget_bytes": self.budget_bytes,
             "bytes_domain": self.bytes_domain,
             "total_bytes": self.total_bytes, "full_bytes": self.full_bytes,
             "quality": self.quality,
             "baseline_quality": self.baseline_quality,
             "notes": self.notes,
             "tables": [t.as_dict() for t in self.tables]}, indent=1)

    @classmethod
    def from_json(cls, text: str) -> "MemoryPlan":
        d = json.loads(text)
        schema = d.pop("schema", SCHEMA_VERSION)
        if schema != SCHEMA_VERSION:
            raise ValueError(f"unsupported plan schema {schema}")
        tables = [TablePlan.from_dict(t) for t in d.pop("tables")]
        return cls(tables=tables, notes=d.pop("notes", {}), **d)

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    @classmethod
    def load(cls, path: str) -> "MemoryPlan":
        with open(path) as f:
            return cls.from_json(f.read())


def _differences(a, b, where: str, quality_tol: float, out: list) -> None:
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b), key=str):
            if k not in a or k not in b:
                out.append(f"{where}/{k}: only in {'the first' if k in a else 'the second'}")
            else:
                _differences(a[k], b[k], f"{where}/{k}", quality_tol, out)
    elif isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            out.append(f"{where}: {len(a)} entries vs {len(b)}")
        for i, (x, y) in enumerate(zip(a, b)):
            _differences(x, y, f"{where}/{i}", quality_tol, out)
    elif isinstance(a, float) or isinstance(b, float):
        if not (isinstance(a, (int, float)) and isinstance(b, (int, float))
                and abs(a - b) <= quality_tol):
            out.append(f"{where}: {a!r} vs {b!r}")
    elif a != b or type(a) is not type(b):
        out.append(f"{where}: {a!r} vs {b!r}")


def plan_differences(a: MemoryPlan, b: MemoryPlan, quality_tol: float = 1e-12) -> list[str]:
    """Where two plans differ, one line per field: every field of the plan,
    its notes and each ``TablePlan`` must be equal, floats (qualities, the
    parked upgrades' quality gains) within ``quality_tol``.  Empty when the
    plans agree: the test that a plan of this package equals one written by
    the JAX package on the same stats."""
    out: list[str] = []
    _differences(json.loads(a.to_json()), json.loads(b.to_json()), "plan", quality_tol, out)
    return out

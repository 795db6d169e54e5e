"""Plan-aware placement of serving tables over the ranks of a process
group, as the JAX package's ``dist/serve_placement.py``.

Production recsys serves tables too big for one host; this module decides,
from the built parameters' per-table bytes (and the memory plan's byte
claim, when given), where each sub-table lives on N ranks:

* **replicate** sub-tables below a replication-byte threshold — small or
  hot tables (the QR quotient side, narrow mixed-width tables) are cheaper
  to copy everywhere than to chat about;
* **row-shard** everything else contiguously: rank ``r`` owns rows
  ``[r·R/N, (r+1)·R/N)`` — itself a quotient partition of the row space.
  Rows are padded up to a multiple of N.

Lookups into a row-sharded sub-table route through ``exchange_rows``: a
**two-phase all-to-all** (``dist.wire``) — phase 1 ships each lookup's row
id to the owning rank, phase 2 ships the rows home.  Quantized tables keep
**int8 on the wire** (q int8, scale bf16, zp int8) and dequantize at the
requesting rank with exactly ``core.compositional.table_rows``'
arithmetic, so the exchanged rows are bit-identical to a local gather.
``dist.accounting.serve_exchange_wire_bytes`` prices the exchange with the
same ring formulas ``dist.wire`` records.

The default threshold derives from the plan: ``total_table_bytes /
(4·N)`` — any sub-table worth more than a quarter of a rank's even share
is sharded; everything smaller replicates.  This bounds per-rank bytes by
``total/N + replicated`` while keeping the quotient sides of QR pairs
local.

A rank of the group stands where a device of the reference's mesh stood:
``place_params`` keeps **this rank's** row block of each sharded
sub-table, and ``exchange_rows`` runs on every rank at once.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist

from ..core.compositional import is_quantized_table
from . import wire

__all__ = ["SubTablePlacement", "ServePlacement", "plan_placement", "place_params",
           "exchange_rows", "sub_table_items", "REPLICATION_DIVISOR"]

# threshold = total_table_bytes / (REPLICATION_DIVISOR * n_devices): a
# sub-table bigger than 1/4 of a rank's even share is worth sharding
REPLICATION_DIVISOR = 4


@dataclasses.dataclass(frozen=True)
class SubTablePlacement:
    """Where one sub-table (one partition's rows) lives."""

    feature: int
    table_key: str          # "table" | "table_0" | "table_1" | ...
    path: str               # "tables/<feature>/<table_key>"
    rows: int
    padded_rows: int        # rows rounded up to a multiple of n (row_shard)
    width: int
    bytes_total: int        # stored bytes (q+scale+zp for quantized tables)
    strategy: str           # "replicate" | "row_shard"
    quantized: bool

    @property
    def pad_bytes(self) -> int:
        return self.bytes_total * (self.padded_rows - self.rows) // max(self.rows, 1)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SubTablePlacement":
        return cls(**d)


@dataclasses.dataclass
class ServePlacement:
    """The full placement decision for one model's tables on N ranks."""

    n_devices: int
    threshold_bytes: int
    entries: list[SubTablePlacement] = dataclasses.field(default_factory=list)

    def entry(self, feature: int, table_key: str) -> SubTablePlacement:
        for e in self.entries:
            if e.feature == feature and e.table_key == table_key:
                return e
        raise KeyError(f"no placement entry for tables/{feature}/{table_key}")

    @property
    def sharded(self) -> list[SubTablePlacement]:
        return [e for e in self.entries if e.strategy == "row_shard"]

    @property
    def replicated(self) -> list[SubTablePlacement]:
        return [e for e in self.entries if e.strategy == "replicate"]

    def total_bytes(self) -> int:
        return sum(e.bytes_total for e in self.entries)

    def replicated_bytes(self) -> int:
        return sum(e.bytes_total for e in self.replicated)

    def pad_bytes(self) -> int:
        return sum(e.pad_bytes for e in self.sharded)

    def bytes_per_device(self) -> int:
        """Resident table bytes on one rank: every replicated sub-table in
        full plus an even 1/N share of each padded row-sharded one."""
        shard = sum((e.bytes_total + e.pad_bytes) // self.n_devices for e in self.sharded)
        return self.replicated_bytes() + shard

    def replicated_features(self, n_features: int) -> np.ndarray:
        """Bool per feature: every sub-table replicated (locally resident) —
        the set the device hot-row cache may hold in sharded serving."""
        out = np.ones(n_features, bool)
        for e in self.sharded:
            out[e.feature] = False
        return out

    def rows_per_device(self, e: SubTablePlacement) -> int:
        return e.padded_rows // self.n_devices

    def summary(self) -> dict:
        return {"n_devices": self.n_devices,
                "threshold_bytes": self.threshold_bytes,
                "sub_tables": len(self.entries),
                "row_sharded": len(self.sharded),
                "replicated": len(self.replicated),
                "total_bytes": self.total_bytes(),
                "replicated_bytes": self.replicated_bytes(),
                "pad_bytes": self.pad_bytes(),
                "bytes_per_device": self.bytes_per_device()}

    def as_dict(self) -> dict:
        return {"n_devices": self.n_devices, "threshold_bytes": self.threshold_bytes,
                "entries": [e.as_dict() for e in self.entries]}

    @classmethod
    def from_dict(cls, d: dict) -> "ServePlacement":
        return cls(n_devices=d["n_devices"], threshold_bytes=d["threshold_bytes"],
                   entries=[SubTablePlacement.from_dict(e) for e in d["entries"]])


def _leaf_bytes(leaf) -> int:
    if is_quantized_table(leaf):
        return sum(_leaf_bytes(v) for v in leaf.values())
    return int(math.prod(leaf.shape)) * leaf.element_size()


def sub_table_items(params) -> list[tuple[int, str, object]]:
    """``(feature, table_key, leaf)`` per sub-table of ``params["tables"]``
    (a leaf is a 2-D tensor or a quantized-table dict), in feature order."""
    return [(i, key, tp[key]) for i, tp in enumerate(params["tables"]) for key in sorted(tp)]


def plan_placement(params, n_devices: int, *, plan=None,
                   threshold_bytes: int | None = None) -> ServePlacement:
    """Place every sub-table of ``params["tables"]`` on ``n_devices`` ranks.

    Byte accounting comes from the built tensors (what is resident); the
    ``plan`` supplies the threshold's byte base when given
    (``plan.total_bytes``).  ``n_devices == 1`` replicates everything.
    Tensors on the ``meta`` device place as real ones do."""
    items = sub_table_items(params)
    total = sum(_leaf_bytes(leaf) for _, _, leaf in items)
    if threshold_bytes is None:
        base = int(getattr(plan, "total_bytes", 0) or 0) or total
        threshold_bytes = max(1, base // (REPLICATION_DIVISOR * max(n_devices, 1)))
    entries = []
    for feature, key, leaf in items:
        q = leaf["q"] if is_quantized_table(leaf) else leaf
        rows, width = int(q.shape[0]), int(q.shape[1])
        nbytes = _leaf_bytes(leaf)
        shard = n_devices > 1 and nbytes > threshold_bytes and rows >= n_devices
        padded = (-rows % n_devices) + rows if shard else rows
        entries.append(SubTablePlacement(
            feature=feature, table_key=key, path=f"tables/{feature}/{key}", rows=rows,
            padded_rows=padded, width=width, bytes_total=nbytes,
            strategy="row_shard" if shard else "replicate",
            quantized=is_quantized_table(leaf)))
    return ServePlacement(n_devices=n_devices, threshold_bytes=int(threshold_bytes),
                          entries=entries)


def _row_block(x: torch.Tensor, padded_rows: int, rank: int, n: int) -> torch.Tensor:
    """Rank ``rank``'s rows of ``x`` padded with zero rows to ``padded_rows``
    (only the last ranks' blocks reach into the padding)."""
    per = padded_rows // n
    lo, hi = rank * per, (rank + 1) * per
    block = x[min(lo, x.shape[0]):min(hi, x.shape[0])]
    if block.shape[0] < per:
        block = torch.cat([block, torch.zeros((per - block.shape[0],) + tuple(x.shape[1:]),
                                              dtype=x.dtype, device=x.device)])
    return block.clone()


def place_params(params, placement: ServePlacement, rank: int):
    """The parameter tree rank ``rank`` serves from: each row-sharded
    sub-table replaced by this rank's block of its rows (padded to
    ``padded_rows``, so every block has ``rows_per_device`` rows); every
    other leaf — replicated sub-tables, MLPs, projections — as it was.
    Returns ``(placed_params, spec_tree)``, the spec tree being
    ``sharding.placement_specs`` of the padded tables (the reference's
    ``shard_map`` in_specs)."""
    from .sharding import placement_specs
    n = placement.n_devices
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} is not one of the placement's {n}")
    params = dict(params)
    tables = [dict(tp) for tp in params["tables"]]
    padded = [dict(tp) for tp in params["tables"]]
    for e in placement.sharded:
        leaf = tables[e.feature][e.table_key]

        def block(x, e=e):
            return _row_block(x, e.padded_rows, rank, n)

        def meta(x, e=e):
            return torch.empty((e.padded_rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                               device="meta")

        if is_quantized_table(leaf):
            tables[e.feature][e.table_key] = {k: block(v) for k, v in leaf.items()}
            padded[e.feature][e.table_key] = {k: meta(v) for k, v in leaf.items()}
        else:
            tables[e.feature][e.table_key] = block(leaf)
            padded[e.feature][e.table_key] = meta(leaf)
    specs = placement_specs(dict(params, tables=padded), placement)
    params["tables"] = tables
    return params, specs


# ------------------------------------------------------------- the exchange


def exchange_rows(leaf, ids, n: int, rows_per_device: int, group=None, *,
                  leaf_path: str = "_unnamed"):
    """Fetch rows of a row-sharded sub-table from their owning ranks.

    Runs on every rank of ``group`` (``None``: the default group, of size
    ``n``) at once.  ``leaf`` is this rank's row block (tensor or quantized
    dict, ``rows_per_device`` rows); ``ids`` is this rank's lookups as
    global row ids (any shape, int).  Two phases, each an all-to-all
    through ``dist.wire`` (logged under ``leaf_path``):

    1. ids out: each lookup's global id maps to ``(owner, local_row)``;
       the local rows pack into an ``(n, C)`` int32 send buffer (C =
       lookups) and go to their owners;
    2. rows back: owners gather their local rows and send them home,
       int8 and bf16 staying narrow on the wire; quantized rows dequantize
       *after* the trip with ``table_rows``' arithmetic.

    Unused send slots carry row 0 (in range; the unpermute ignores them),
    so the result is bit-identical to a local gather from the whole
    table."""
    if dist.get_world_size(group) != n:
        raise ValueError(f"the exchange is over {n} ranks, the group has "
                         f"{dist.get_world_size(group)}")
    shape = tuple(ids.shape)
    flat = ids.reshape(-1).to(torch.int64)
    c = flat.numel()
    owners = torch.div(flat, rows_per_device, rounding_mode="floor")
    local = flat - owners * rows_per_device
    # position of each lookup within its owner's bucket: one-hot cumsum
    onehot = (owners[:, None] == torch.arange(n, device=flat.device)[None, :]).to(torch.int64)
    pos = torch.cumsum(onehot, dim=0).gather(1, owners[:, None])[:, 0] - 1
    send = torch.zeros((n, c), dtype=torch.int32, device=flat.device)
    send[owners, pos] = local.to(torch.int32)
    recv = wire.all_to_all(send, group, leaf=leaf_path).to(torch.int64)   # (n, C)

    def route(shard):
        rows = shard[recv]                                                # (n, C, w)
        home = wire.all_to_all(rows.reshape(n, -1), group, leaf=leaf_path)
        return home.reshape(rows.shape)[owners, pos]                      # (C, w)

    if is_quantized_table(leaf):
        q = route(leaf["q"]).to(torch.float32)
        zp = route(leaf["zp"]).to(torch.float32)
        scale = route(leaf["scale"]).to(torch.float32)
        out = (q - zp) * scale                      # == table_rows' bits
    else:
        out = route(leaf)
    return out.reshape(shape + (out.shape[-1],))


"""Layer-2 collective auditor (WIRE-001): ``dist.accounting`` closed forms
must equal the bytes every registered exchange really hands to
``torch.distributed`` — exactly.

The port's counterpart of the JAX package's ``analysis/wire_audit.py``,
which prices the compiled HLO of each exchange.  Here each exchange runs
in a gloo world of ``ctx.world`` ranks (``dist.world.spawn``; on a CUDA
device every rank keeps its tensors on the card, cuda:0, and gloo moves
them).  During the audit each rank wraps ``torch.distributed``'s
``all_to_all_single``, ``all_gather``, ``all_gather_into_tensor`` and
``all_reduce`` and prices every call it sees with ``accounting``'s ring
formulas from the tensors handed over — a count independent of
``dist.wire``'s own ledger.  Three numbers must agree to **zero bytes**:
the intercepted count, ``dist.wire.snapshot()`` and the closed form.

The exchanges are the reference's eight, at its shapes: the data-parallel
compressed mean-all-reduce (``ef_psum_grads``) and the FSDP compressed
reduce-scatter plus f32 parameter all-gather, each in modes none / bf16 /
int8, and the sharded-serving row exchange (``exchange_rows``) of f32 and
int8 rows.  A world of one rank emits a finding rather than passing
vacuously.

``REPRO_ANALYSIS_INJECT=wire`` perturbs the closed form (test hook, as
in the reference) so a test can prove a real mismatch fails the run.
"""

from __future__ import annotations

import json
import math
import os
import tempfile

import numpy as np
import torch

from .findings import Finding
from .registry import Context, register_pass

__all__ = ["wire_programs", "run_world", "audit_rows", "Interceptor",
           "DP_SHAPES", "FSDP_SHAPES", "SERVE_ROWS_PER_RANK", "SERVE_WIDTH",
           "SERVE_LOOKUPS"]

_RULE = "WIRE-001"
# the reference's shapes (repro/analysis/wire_audit.py:43-136)
DP_SHAPES = {"table": (64, 16), "w": (33, 7), "b": (7,)}
FSDP_SHAPES = {"table": (64, 16), "w": (40, 8)}
SERVE_ROWS_PER_RANK, SERVE_WIDTH, SERVE_LOOKUPS = 8, 16, 24
# where each collective takes its group when passed by position
_GROUP_ARG = {"all_to_all_single": 4, "all_gather": 2, "all_gather_into_tensor": 2,
              "all_reduce": 2}


def _nbytes(t) -> float:
    return float(t.numel() * t.element_size())


class Interceptor:
    """While entered, every ``torch.distributed`` collective of
    ``_GROUP_ARG`` this process calls adds its per-device ring bytes —
    priced from the tensors it is handed — to ``bytes``."""

    def __init__(self):
        self.bytes = 0.0
        self.calls = 0
        self._orig: dict = {}

    def _price(self, name, args, kwargs) -> float:
        import torch.distributed as dist

        from ..dist import accounting
        i = _GROUP_ARG[name]
        group = kwargs.get("group", args[i] if len(args) > i else None)
        n = dist.get_world_size(group)
        if name == "all_to_all_single":
            return accounting.ring_all_to_all_bytes(_nbytes(args[1]), n)
        if name == "all_gather":
            return accounting.ring_all_gather_bytes(sum(map(_nbytes, args[0])), n)
        if name == "all_gather_into_tensor":
            return accounting.ring_all_gather_bytes(_nbytes(args[0]), n)
        return accounting.ring_all_reduce_bytes(_nbytes(args[0]), n)

    def _wrap(self, name, fn):
        def call(*args, **kwargs):
            self.bytes += self._price(name, args, kwargs)
            self.calls += 1
            return fn(*args, **kwargs)
        return call

    def __enter__(self):
        import torch.distributed as dist
        for name in _GROUP_ARG:
            self._orig[name] = getattr(dist, name)
            setattr(dist, name, self._wrap(name, self._orig[name]))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for name, fn in self._orig.items():
            setattr(dist, name, fn)
        self._orig = {}
        return False


# ------------------------------------------------------------ exchanges
# each ``run(group, n, rank, device)`` performs one exchange on this rank
# and returns its closed-form per-device wire bytes


def _tree(shapes, rank, device):
    rng = np.random.default_rng(rank)
    return {k: torch.as_tensor(rng.normal(size=s), dtype=torch.float32).to(device)
            for k, s in shapes.items()}


def _dp_psum(mode: str):
    """The compressed data-parallel mean-all-reduce of a small gradient
    tree — the exchange ``make_dp_train_step`` runs per step."""
    def run(group, n, rank, device):
        from ..dist import accounting
        from ..dist.compress import ef_psum_grads, init_error_state
        grads = _tree(DP_SHAPES, rank, device)
        ef_psum_grads(grads, init_error_state(grads), group=group, mode=mode)
        return accounting.grad_wire_bytes(grads, mode, n, pattern="all_reduce")["total_bytes"]
    return f"dp_psum[{mode}]", run


def _fsdp(mode: str):
    """Compressed reduce-scatter per leaf + f32 all-gather of the reduced
    shard — the two collectives of ``make_fsdp_train_step``."""
    def run(group, n, rank, device):
        from ..dist import accounting, wire
        from ..dist.compress import _reduce_scatter_leaf, init_error_state
        leaves = _tree(FSDP_SHAPES, rank, device)
        err = init_error_state(leaves)
        for k in leaves:
            shard, _ = _reduce_scatter_leaf(leaves[k], err[k], group, mode, 0, leaf=k)
            wire.all_gather(shard, group, leaf=k)
        return sum(accounting.leaf_reduce_bytes(mode, math.prod(s), n, pattern="reduce_scatter")
                   + accounting.ring_all_gather_bytes(4.0 * math.prod(s), n)
                   for s in FSDP_SHAPES.values())
    return f"fsdp_rs_gather[{mode}]", run


def _serve_exchange(quantized: bool):
    """The two-phase sharded-serve row fetch (``exchange_rows``) for one
    sub-table and wave: each rank holds its row block and looks up
    ``SERVE_LOOKUPS`` global rows."""
    def run(group, n, rank, device):
        from ..dist import accounting
        from ..dist.serve_placement import exchange_rows
        from ..serve.quantize import quantize_table
        rows = SERVE_ROWS_PER_RANK
        rng = np.random.default_rng(0)
        w = torch.as_tensor(rng.normal(size=(rows * n, SERVE_WIDTH)), dtype=torch.float32)
        ids = torch.as_tensor(rng.integers(0, rows * n, (n, SERVE_LOOKUPS)))
        block = slice(rank * rows, (rank + 1) * rows)
        leaf = ({k: v[block].contiguous().to(device) for k, v in quantize_table(w).items()}
                if quantized else w[block].to(device))
        exchange_rows(leaf, ids[rank].to(device), n, rows, group, leaf_path="serve")
        return accounting.serve_exchange_wire_bytes(
            SERVE_LOOKUPS, SERVE_WIDTH, n, quantized=quantized,
            row_dtype_bytes=4)["total_bytes"]
    return f"serve_exchange[{'int8' if quantized else 'f32'}]", run


def wire_programs():
    """Every registered (name, run) exchange the auditor certifies."""
    progs = [_dp_psum(m) for m in ("none", "bf16", "int8")]
    progs += [_fsdp(m) for m in ("none", "bf16", "int8")]
    progs += [_serve_exchange(q) for q in (False, True)]
    return progs


# --------------------------------------------------------------- a world


def _rank_main(rank, n, device, out_dir):
    """One rank: run every exchange, intercepted, and save what it saw."""
    import torch.distributed as dist

    from ..dist import wire
    device = torch.device(device)
    rows = []
    for name, run in wire_programs():
        wire.reset()
        icpt = Interceptor()
        try:
            with icpt:
                closed = run(dist.group.WORLD, n, rank, device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            rows.append({"name": name, "closed_form_bytes": closed,
                         "intercepted_bytes": icpt.bytes, "calls": icpt.calls,
                         "wire_bytes": wire.snapshot()["total_bytes"]})
        except Exception as e:
            rows.append({"name": name, "error": repr(e)})
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rows, f)


def run_world(n: int, device: str) -> list[list[dict]]:
    """Every exchange in a gloo world of ``n`` ranks on ``device``: one
    list of rows per rank."""
    from ..dist import world
    with tempfile.TemporaryDirectory(prefix="repro_torch_wire_") as d:
        world.spawn(_rank_main, n, "gloo", device, d)
        out = []
        for r in range(n):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                out.append(json.load(f))
    return out


def audit_rows(per_rank: list[list[dict]]) -> tuple[list[Finding], list[dict]]:
    """Hold every rank's intercepted and recorded bytes to the closed form."""
    findings, rows = [], []
    n = len(per_rank)
    for i, (name, _) in enumerate(wire_programs()):
        anchor = f"analysis://wire/{name}"
        seen = [ranks[i] for ranks in per_rank]
        errors = [(r, s["error"]) for r, s in enumerate(seen) if "error" in s]
        if errors:
            findings.append(Finding(rule=_RULE, path=anchor, line=0, layer=2,
                                    message=f"exchange failed to run on rank "
                                            f"{errors[0][0]}: {errors[0][1]}"))
            rows.append({"name": name, "error": errors[0][1]})
            continue
        closed = seen[0]["closed_form_bytes"]
        if os.environ.get("REPRO_ANALYSIS_INJECT") == "wire":
            closed += 64.0   # test hook: prove a mismatch fails the run
        row = {"name": name, "closed_form_bytes": closed,
               "intercepted_bytes": seen[0]["intercepted_bytes"],
               "wire_bytes": seen[0]["wire_bytes"], "calls": seen[0]["calls"],
               "ranks": n}
        rows.append(row)
        bad = [(r, s) for r, s in enumerate(seen)
               if abs(s["intercepted_bytes"] - closed) > 1e-6
               or abs(s["wire_bytes"] - closed) > 1e-6]
        if bad:
            r, s = bad[0]
            findings.append(Finding(
                rule=_RULE, path=anchor, line=0, layer=2,
                message=f"accounting closed form ({closed:.0f} B) != the bytes "
                        f"handed to torch.distributed ({s['intercepted_bytes']:.0f} B "
                        f"intercepted, {s['wire_bytes']:.0f} B recorded by dist.wire) "
                        f"on rank {r} of {n} — dist.accounting and the exchange "
                        "have drifted apart"))
    return findings, rows


@register_pass(_RULE, "wire-accounting", 2,
               "dist.accounting closed forms == the bytes every registered "
               "exchange hands to torch.distributed")
def wire_pass(ctx: Context) -> list[Finding]:
    if ctx.world < 2:
        return [Finding(
            rule=_RULE, path="analysis://wire", line=0, layer=2,
            message=f"a world of {ctx.world} rank(s) — the wire audit needs at "
                    "least 2 (--world); refusing to pass vacuously")]
    findings, rows = audit_rows(run_world(ctx.world, ctx.device))
    ctx.notes[_RULE] = {"exchanges": rows, "world": ctx.world, "device": ctx.device}
    return findings

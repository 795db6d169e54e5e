"""Layer-2 shape-stability watcher (JIT-002): replay a canonical request
stream through the port's ``RecsysEngine`` and fail if the programs'
input-shape signatures exceed the pow2-bucket bound — the JAX package's
``analysis/jit_audit.py`` on the port's engine.

The engine's latency story rests on one invariant: every wave pads to a
(pow2 batch, pow2 bag) bucket, so the number of distinct input shapes a
program sees — the programs a per-bucket CUDA graph would capture, and
the count the reference's jit caches hold — is O(log max_batch · log
max_bag), and zero new ones once the bucket grid is warm.  A padding
regression that leaks one unbucketed shape into the hot path turns p99
into a storm of first launches; this pass catches it as arithmetic:

* after draining a deterministic stream spanning the bucket grid, the
  embed program may have seen at most one signature per (batch, bag)
  bucket, and the dense program at most one per batch bucket;
* replaying the *same* stream must add **zero** new signatures.

Uses :meth:`RecsysEngine.compile_count` (signature sets, no timing).
The pass builds the reference's small int8 engine on ``ctx.device`` from
a seeded torch init; ``replay_and_audit`` takes any engine (the smoke
script replays the full-width one).
"""

from __future__ import annotations

from .findings import Finding
from .registry import Context, register_pass

__all__ = ["replay_and_audit", "canonical_stream", "small_config"]

_RULE = "JIT-002"
_ANCHOR = "analysis://jit/recsys-replay"


def canonical_stream(sizes, n_requests: int = 40, max_bag: int = 8):
    """Deterministic request stream spanning bag buckets {1, 2, 4, 8}:
    the reference's, drawn from numpy seed 0."""
    import numpy as np
    rng = np.random.default_rng(0)
    reqs = []
    for _ in range(n_requests):
        bag_len = int(rng.integers(1, max_bag + 1))
        reqs.append((rng.normal(size=13),
                     [list(rng.integers(0, s, size=bag_len)) for s in sizes]))
    return reqs


def small_config():
    """The reference's engine config (three QR tables, c=4, threshold 40),
    served through the kernels: on a CUDA device each wave is one grouped
    K4 and one K2 (the signatures do not depend on the route)."""
    from ..core.factory import EmbeddingSpec
    from ..models.dlrm import DLRMConfig
    return DLRMConfig(table_sizes=(100, 500, 33), emb_dim=16,
                      bottom_mlp=(32, 16), top_mlp=(32,),
                      embedding=EmbeddingSpec(kind="qr", num_collisions=4,
                                              threshold=40), use_kernel=True)


def _build_engine(device):
    import torch
    from ..models.dlrm import dlrm_init
    from ..serve.quantize import quantize_params
    from ..serve.recsys import RecsysEngine
    cfg = small_config()
    params = quantize_params(dlrm_init(cfg, torch.Generator().manual_seed(0), "cpu"))
    return RecsysEngine(cfg, params, max_batch=8, device=device)


def replay_and_audit(engine) -> tuple[list[Finding], dict]:
    """Drain the canonical stream twice; return (findings, telemetry)."""
    findings: list[Finding] = []
    reqs = canonical_stream(engine.cfg.table_sizes)
    for dense, bags in reqs:
        engine.submit(dense, bags)
    engine.run_until_drained()
    counts = engine.compile_count()
    per = counts["per_program"]
    buckets = set(engine.buckets_seen)
    batch_buckets = {bb for bb, _ in buckets}
    bounds = {"embed": len(buckets), "dense": len(batch_buckets)}
    for prog, bound in bounds.items():
        got = per.get(prog)
        if got is not None and got > bound:
            findings.append(Finding(
                rule=_RULE, path=_ANCHOR, line=0, layer=2,
                message=f"{prog} program saw {got} input shapes for "
                        f"{bound} pow2 bucket(s) {sorted(buckets)} — a shape "
                        "escaped the bucket grid"))
    # steady state: the identical stream must not add a signature
    for dense, bags in reqs:
        engine.submit(dense, bags)
    engine.run_until_drained()
    after = engine.compile_count()
    if after["total"] != counts["total"]:
        findings.append(Finding(
            rule=_RULE, path=_ANCHOR, line=0, layer=2,
            message=f"replaying the identical stream added "
                    f"{after['total'] - counts['total']} input shape(s) — the "
                    "warm path is not shape-stable"))
    telemetry = {"first_pass": counts, "replay": after,
                 "buckets_seen": sorted(buckets), "bounds": bounds,
                 "requests": len(reqs) * 2, "waves": len(engine.wave_sizes)}
    return findings, telemetry


@register_pass(_RULE, "jit-cache-bound", 2,
               "RecsysEngine input-shape signatures stay within the "
               "pow2-bucket bound over a canonical replay")
def jit_cache_pass(ctx: Context) -> list[Finding]:
    findings, telemetry = replay_and_audit(_build_engine(ctx.device))
    ctx.notes[_RULE] = telemetry
    return findings

"""The paper's §5 experiment on the port, one function per table or figure
(``fig4``, ``fig5``, ``fig6``, ``table1``), as the JAX package's
``benchmarks/paper_tables.py`` runs it: the reduced configs (10 tables at
the paper's widths) trained for ``TRAIN_STEPS`` steps at batch 256 on the
seeded synthetic Criteo-shaped stream, then scored on the held-out steps
10,000-10,011.  Each function returns CSV rows ``(name, us_per_call,
derived)`` with the reference's names and derived strings, and writes the
reference's artifact (``loss``, ``acc``, ``params`` per row) under
``artifacts/bench_torch/``, beside ``<tag>_detail.json`` with what only the
port records.

**One stream for every device.**  The initial parameters are drawn on the
CPU (``api(cfg, device="cpu").init(torch.Generator().manual_seed(seed))``)
and so are the batches (``data.criteo.batch_at(0, step, 256, spec,
device="cpu")``); both are copied to ``device``.  A CPU generator cannot
draw onto a CUDA device and a CUDA generator draws other numbers, so
drawing on the card would give it another experiment than the CPU's.
Drawn on the CPU, the card, any CPU and the reference fed the same arrays
run one experiment.  The batch is drawn and copied inside the timed loop,
as the reference draws its batch there; the host time of the draw and the
copy is reported as its share of the timed steps.

**Held-out scoring twice.**  Every DLRM row scores the trained parameters
on the reference's plain path, which is the quantity the row reports, and
again with ``use_kernel=True``.  The kernel route's BCE and logits must
equal the plain path's within ``SCORE_TOL``, and on the card its launches
must be ``expected_launches``: one K2 per batch, and K1 for the dense
mult/add QR pairs, one grouped launch per batch where every table is one,
else one per pair and batch.  DCN rows run no kernel: ``DCNConfig`` has no
``use_kernel``, as in the reference.

Run: ``python -m repro_torch.benchmarks.paper_tables [--only SUBSTR]
[--device cpu]`` (default ``cuda``); ``REPRO_BENCH_STEPS`` sets the
training steps (default 400).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from .. import tree
from ..configs import dcn_criteo, dlrm_criteo
from ..configs.common import Shape
from ..core import CompositionalEmbedding
from ..kernels import launch_counters
from ..models.dlrm import tables_for
from ..train.loop import init_state, make_train_step

__all__ = ["TRAIN_STEPS", "EVAL_STEPS", "BATCH", "SHAPE", "HELDOUT", "SCORE_TOL", "RowSpec",
           "RowResult", "TrainRun", "row_specs", "setup", "to_device", "train", "heldout",
           "expected_launches", "kernel_scoring", "run_row", "fig4", "fig5", "fig6", "table1",
           "main"]

ART = "artifacts/bench_torch"
TRAIN_STEPS = int(os.environ.get("REPRO_BENCH_STEPS", "400"))
EVAL_STEPS = 12
BATCH = 256
SHAPE = Shape("bench", 1, BATCH, "train")
HELDOUT = range(10_000, 10_000 + EVAL_STEPS)
# kernel route vs plain path on the same parameters: f32 sums in another
# order through the lookups, the interaction and two MLPs
SCORE_TOL = 1e-4
MODULES = {"dlrm": dlrm_criteo, "dcn": dcn_criteo}


@dataclasses.dataclass
class RowSpec:
    """One row: its CSV name, its key in the section's artifact, the net
    and ``run_row``'s keywords; fig4's and fig5's base row print no
    ``params`` in ``derived``, and fig5's base row records no ``acc``."""
    name: str
    key: str
    net: str
    kw: dict
    params_in_derived: bool = True
    acc_in_artifact: bool = True

    @property
    def section(self) -> str:
        return self.name.split("/")[0]


@dataclasses.dataclass
class TrainRun:
    state: dict
    losses: list            # every step's training loss
    us_per_step: float      # host clock over steps 1..N-1, one synchronize at the end
    batch_share: float      # share of that time spent drawing and copying batches


@dataclasses.dataclass
class RowResult:
    loss: float             # held-out BCE, plain path
    acc: float
    params: int
    us_per_step: float
    batch_share: float
    train_losses: list
    kernel: dict | None     # kernel-route scoring (DLRM rows), None for DCN rows


def _paper_kinds(op_list=("hash", "mult", "add", "concat", "feature")):
    for kind in op_list:
        if kind == "hash":
            yield "hash", "hash", "mult"
        elif kind == "feature":
            yield "feature", "feature", "mult"
        else:
            yield kind, "qr", kind


def row_specs() -> list[RowSpec]:
    """The 30 rows of the four sections, in the reference's order."""
    specs = [RowSpec(f"fig4/{net}/{name}", f"{net}/{name}", net,
                     dict(embedding=kind, num_collisions=4), params_in_derived=False)
             for net in ("dlrm", "dcn")
             for name, kind in (("full", "full"), ("hash", "hash"), ("qr_mult", "qr"))]
    specs.append(RowSpec("fig5/dlrm/full/c0", "full/0", "dlrm", dict(embedding="full"),
                         params_in_derived=False, acc_in_artifact=False))
    specs += [RowSpec(f"fig5/dlrm/{label}/c{c}", f"{label}/{c}", "dlrm",
                      dict(embedding=kind, num_collisions=c, op=op))
              for c in (2, 4, 60) for label, kind, op in _paper_kinds()]
    specs += [RowSpec(f"fig6/dlrm/qr_mult/thr{thr}", str(thr), "dlrm",
                      dict(embedding="qr", num_collisions=4, threshold=thr))
              for thr in (0, 200, 2000, 20000)]
    specs += [RowSpec(f"table1/dlrm/path/h{h}", str(h), "dlrm",
                      dict(embedding="path", num_collisions=4, path_hidden=h))
              for h in (16, 32, 64, 128)]
    return specs


def setup(mod, *, embedding, num_collisions=4, threshold=0, op="mult", seed=0, **cfg_kw):
    """The row's reduced config, its ``api`` on the CPU and its initial
    parameters, drawn on the CPU from ``seed``."""
    cfg = mod.config(reduced=True, embedding=embedding, num_collisions=num_collisions,
                     threshold=threshold, op=op, **cfg_kw)
    api = mod.api(cfg, device="cpu")
    return cfg, api, api.init(torch.Generator().manual_seed(seed))


def to_device(x, device):
    """A tree of tensors copied to ``device``."""
    return tree.tree_map(lambda t: t.to(device, non_blocking=True), x)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(loss_fn, optimizer, params, batch_at, steps: int, device) -> TrainRun:
    """``steps`` steps of ``make_train_step(loss_fn, optimizer)`` from
    ``params`` on ``device``, step ``s`` on ``batch_at(s)`` copied to
    ``device``.  Step 0 warms up; steps 1..steps-1 are timed on the host
    clock and end in one synchronize, as the reference times them around
    ``block_until_ready``.  Every step's loss stays on the device until
    the end."""
    device = torch.device(device)
    step_fn = make_train_step(loss_fn, optimizer)
    state = init_state(to_device(params, device), optimizer)
    state, metrics = step_fn(state, to_device(batch_at(0), device))
    losses = [metrics["loss"]]
    _sync(device)
    batch_s = 0.0
    t0 = time.perf_counter()
    for s in range(1, steps):
        t = time.perf_counter()
        batch = to_device(batch_at(s), device)
        batch_s += time.perf_counter() - t
        state, metrics = step_fn(state, batch)
        losses.append(metrics["loss"])
    _sync(device)
    total_s = time.perf_counter() - t0
    return TrainRun(state, torch.stack(losses).cpu().tolist(),
                    total_s / max(steps - 1, 1) * 1e6, batch_s / total_s if total_s else 0.0)


def heldout(loss_fn, params, batches) -> tuple[float, float]:
    """Mean BCE and accuracy of ``loss_fn`` over ``batches``, each batch's
    loss and accuracy read back to the host, as the reference scores."""
    losses, accs = [], []
    with torch.no_grad():
        for batch in batches:
            loss, metrics = loss_fn(params, batch)
            losses.append(float(loss))
            accs.append(float(metrics["acc"]))
    return float(np.mean(losses)), float(np.mean(accs))


def expected_launches(cfg, n_batches: int) -> dict:
    """Kernel launches of ``n_batches`` held-out batches with
    ``use_kernel=True`` on the card: one K2 per batch, and K1 for the
    dense mult/add QR pairs (none in feature mode) — one grouped launch
    per batch where every table is one, else one per pair and batch."""
    modules = tables_for(cfg)
    pairs = 0 if cfg.embedding.kind == "feature" else sum(
        isinstance(m, CompositionalEmbedding) and len(m.partitions) == 2
        and m.op in ("mult", "add") for m in modules)
    out = {"dot_interaction": n_batches}
    if pairs:
        out["qr_gather"] = n_batches * (1 if pairs == len(modules) else pairs)
    return out


def _launches() -> dict:
    return {name: fn.launches for name, fn in launch_counters().items()}


def kernel_scoring(mod, cfg, params, batches, plain_bce: float, device) -> dict:
    """Held-out scoring of the same parameters with ``use_kernel=True``:
    its BCE and accuracy, its largest |Δlogit| against the plain path, and
    the launches the scoring made of each kernel (the comparison's own
    launches are taken off the counters again).  Raises unless it equals the
    plain path within ``SCORE_TOL`` and, on the card, launched
    ``expected_launches`` (on the CPU the wrappers take their plain
    versions and launch nothing)."""
    device = torch.device(device)
    kapi = mod.api(dataclasses.replace(cfg, use_kernel=True), device=device)
    plain = mod.api(cfg, device=device)
    before = _launches()
    bce, acc = heldout(kapi.loss_fn, params, batches)
    after = _launches()
    launches = {k: v - before[k] for k, v in after.items() if v != before[k]}
    with torch.no_grad():
        dlogit = max(float((kapi.predict(params, b) - plain.predict(params, b)).abs().max())
                     for b in batches)
    for name, fn in launch_counters().items():
        fn.launches = after[name]   # launches made to compare with the plain path count nowhere
    expected = expected_launches(cfg, len(batches)) if device.type == "cuda" else {}
    out = {"bce": bce, "acc": acc, "abs_dbce": abs(bce - plain_bce), "max_abs_dlogit": dlogit,
           "launches": launches, "expected_launches": expected}
    if not (out["abs_dbce"] <= SCORE_TOL and dlogit <= SCORE_TOL):
        raise RuntimeError(f"kernel scoring disagrees with the plain path: |ΔBCE| "
                           f"{out['abs_dbce']:.3e}, max |Δlogit| {dlogit:.3e} (tol {SCORE_TOL})")
    if launches != expected:
        raise RuntimeError(f"kernel scoring launched {launches}, expected {expected}")
    return out


def run_row(mod, *, embedding, num_collisions=4, threshold=0, op="mult", steps=TRAIN_STEPS,
            seed=0, device="cuda", **cfg_kw) -> RowResult:
    """Train one reduced config on ``device`` and score it held out (twice
    for a DLRM row)."""
    cfg, api, params = setup(mod, embedding=embedding, num_collisions=num_collisions,
                             threshold=threshold, op=op, seed=seed, **cfg_kw)
    n_params = sum(p.numel() for p in tree.leaves(params))
    run = train(api.loss_fn, api.optimizer, params, lambda s: api.batch_fn(s, SHAPE), steps,
                device)
    trained = run.state["params"]
    batches = [to_device(api.batch_fn(s, SHAPE), device) for s in HELDOUT]
    loss, acc = heldout(api.loss_fn, trained, batches)
    kernel = (kernel_scoring(mod, cfg, trained, batches, loss, device)
              if hasattr(cfg, "use_kernel") else None)
    return RowResult(loss, acc, n_params, run.us_per_step, run.batch_share, run.losses, kernel)


def _train_eval(mod, *, embedding, num_collisions=4, threshold=0, op="mult",
                steps=TRAIN_STEPS, seed=0, device="cuda", **cfg_kw):
    """Train a reduced config; return (test_loss, test_acc, n_params, us/step)."""
    r = run_row(mod, embedding=embedding, num_collisions=num_collisions, threshold=threshold,
                op=op, steps=steps, seed=seed, device=device, **cfg_kw)
    return r.loss, r.acc, r.params, r.us_per_step


def _emit(tag, rows):
    os.makedirs(ART, exist_ok=True)
    with open(os.path.join(ART, tag + ".json"), "w") as f:
        json.dump(rows, f, indent=1)


def _kernel_note(spec: RowSpec, r: RowResult) -> str:
    if r.kernel is None:
        return f"# {spec.name}: no kernel (DCNConfig has no use_kernel, as in the reference)"
    k = r.kernel
    return (f"# {spec.name}: kernel-route BCE {k['bce']:.6f} (|Δ| {k['abs_dbce']:.3e}), "
            f"max |Δlogit| {k['max_abs_dlogit']:.3e}, launches {k['launches']}")


def _section(tag: str, device) -> list:
    rows, art, detail = [], {}, {}
    for spec in row_specs():
        if spec.section != tag:
            continue
        r = run_row(MODULES[spec.net], device=device, **spec.kw)
        derived = f"test_loss={r.loss:.4f}" + (f";params={r.params}"
                                               if spec.params_in_derived else "")
        rows.append((spec.name, r.us_per_step, derived))
        art[spec.key] = ({"loss": r.loss, "acc": r.acc, "params": r.params}
                         if spec.acc_in_artifact else {"loss": r.loss, "params": r.params})
        detail[spec.key] = {"name": spec.name, "device": str(device),
                            "us_per_step": r.us_per_step, "batch_share": r.batch_share,
                            "loss_step_0": r.train_losses[0],
                            "loss_last_10": float(np.mean(r.train_losses[-10:])),
                            "kernel": r.kernel}
        print(_kernel_note(spec, r), file=sys.stderr)
    _emit(tag, art)
    _emit(tag + "_detail", detail)
    return rows


def fig4(device="cuda"):
    """Fig.4: full vs hashing trick vs QR (mult) on DLRM + DCN (4 collisions)."""
    return _section("fig4", device)


def fig5(device="cuda"):
    """Fig.5: params vs test loss across collision counts × operations."""
    return _section("fig5", device)


def fig6(device="cuda"):
    """Fig.6/Table 4: thresholding sweep at 4 collisions (mult op)."""
    return _section("fig6", device)


def table1(device="cuda"):
    """Table 1/2: path-based compositional embeddings, MLP width sweep."""
    return _section("table1", device)


def main(argv=None) -> int:
    from .run import harness

    return harness([fig4, fig5, fig6, table1], argv)


if __name__ == "__main__":
    sys.exit(main())

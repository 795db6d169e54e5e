"""Fault-tolerant training loop on one device.

* **restart determinism** — data is stateless per step and the state holds
  the step counter, so kill-at-step-k + resume replays the exact stream;
  the restart test asserts bitwise-equal parameters.  On a CUDA device
  that needs ``torch.use_deterministic_algorithms(True)`` (the backward of
  a table gather accumulates with atomics otherwise) and
  ``CUBLAS_WORKSPACE_CONFIG`` set before the first cuBLAS call.
* **atomic async checkpoints** — see ``repro_torch.ckpt``; the loop
  resumes from the newest *valid* checkpoint (corrupt or partial ones are
  skipped).
* **straggler watchdog** — per-step wall time is tracked; steps slower
  than ``watchdog_factor ×`` the running median are logged as straggler
  events;
* **observability** — with ``obs=Obs(...)`` each step lands in a step-time
  histogram, the steps and straggler counters and, with tracing on, a
  ``train_step`` event (the step number in its args); with ``obs=None``
  none of it runs.  While a tracer is active (``Trainer.run`` makes
  ``obs.tracer`` active) each step records the program's spans
  ``repro.train.forward``, ``repro.train.backward`` and
  ``repro.train.optimizer``, which lie inside that step's ``train_step``
  event.

* **gradient compression** — ``make_dp_train_step`` reduces gradients
  over a ``torch.distributed`` process group with bf16/int8 error
  feedback, uniform or per leaf through a ``CompressionPolicy``
  (``repro_torch.dist.compress`` / ``dist.policy``); with ``step_wire=``
  the ``Trainer`` counts each leaf's accounted wire bytes per step.
* **reduce-scatter FSDP grad path** — ``make_fsdp_train_step``
  reduce-scatters compressed gradients, applies the optimizer on each
  rank's shard (optimizer state sharded: per-rank optimizer memory ÷ N),
  and all-gathers the updated parameters.  Scatter dims come from the
  sharding rule engine (``dist.sharding.scatter_dims``).

The step is functional, as the reference's jitted step is: it returns a
new state of plain tensors (no autograd graph) and leaves the old one as
it was.  Gradients come from ``torch.autograd.grad`` on detached aliases
of the parameter leaves (``value_and_grad``), dense for every leaf as
``jax.grad``'s are.

A rank of a ``torch.distributed`` process group stands where a device of
the reference's ``shard_map`` mesh stood: every rank runs the same step
on the same global batch and keeps its own block of it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import statistics
import time
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from .. import tree
from ..ckpt import checkpoint as ckpt
from ..obs.trace import span
from ..optim.optimizers import Optimizer, clip_by_global_norm

__all__ = ["TrainConfig", "init_state", "make_train_step", "make_dp_train_step",
           "make_fsdp_train_step", "init_dp_state", "init_fsdp_state", "fsdp_plan",
           "fsdp_state_shardings", "gather_fsdp_state", "value_and_grad", "Trainer",
           "SimulatedFailure"]


class SimulatedFailure(RuntimeError):
    """Raised by the loop's fault-injection hook (tests)."""


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    num_steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep: int = 3
    clip_norm: Optional[float] = None
    watchdog_factor: float = 3.0


def init_state(params, optimizer: Optimizer):
    device = next((leaf.device for leaf in tree.leaves(params)), torch.device("cpu"))
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def value_and_grad(loss_fn):
    """``jax.value_and_grad(loss_fn, has_aux=True)``: a function of
    ``(params, batch)`` returning ``((loss, metrics), grads)``, with
    ``grads`` a tree like ``params`` (zeros for a leaf the loss does not
    reach) and every returned tensor detached.  The loss is taken in a
    ``repro.train.forward`` span, the gradients in ``repro.train.backward``."""

    def fn(params, batch):
        flat = tree.leaves(params)
        live = [p.detach().requires_grad_(True) for p in flat]
        with torch.enable_grad():
            with span("repro.train.forward"):
                loss, metrics = loss_fn(tree.unflatten(params, live), batch)
            with span("repro.train.backward"):
                grads = torch.autograd.grad(loss, live, allow_unused=True,
                                            materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (loss.detach(), metrics), tree.unflatten(params, list(grads))

    return fn


def make_train_step(loss_fn, optimizer: Optimizer, *, clip_norm=None,
                    accum: int = 1, accum_dtype=torch.float32):
    """The step: grads → (clip) → optimizer → new state.

    ``accum`` > 1 splits the global batch into ``accum`` microbatches along
    dim 0 and runs them one after another, accumulating the gradients in
    ``accum_dtype``; loss and metrics are microbatch means.  A DTensor
    batch split over ranks along dim 0 is split on each rank
    (``_microbatch``), into ``gcd(accum, local rows)`` microbatches where a
    rank holds fewer rows than ``accum``.
    """
    grads_of = value_and_grad(loss_fn)

    def step(state, batch):
        params = state["params"]
        n_micro = _n_micro(batch, accum)
        if n_micro == 1:
            (loss, metrics), grads = grads_of(params, batch)
        else:
            g_acc = [torch.zeros_like(p, dtype=accum_dtype) for p in tree.leaves(params)]
            loss_sum, metricss = 0.0, []
            for i in range(n_micro):
                micro = {k: _microbatch(v, n_micro, i) for k, v in batch.items()}
                (mloss, mmetrics), g = grads_of(params, micro)
                g_acc = [a + b.to(accum_dtype) for a, b in zip(g_acc, tree.leaves(g))]
                loss_sum = loss_sum + mloss
                metricss.append(mmetrics)
            grads = tree.unflatten(params, [g / n_micro for g in g_acc])
            loss = loss_sum / n_micro
            metrics = {k: torch.stack([m[k] for m in metricss]).mean() for k in metricss[0]}
        if clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            metrics = dict(metrics, grad_norm=gnorm)
        with span("repro.train.optimizer"):
            new_params, new_opt = optimizer.update(grads, state["opt"], params, state["step"])
        new_state = {"params": new_params, "opt": new_opt, "step": state["step"] + 1}
        return new_state, dict(metrics, loss=loss)

    return step


def _n_micro(batch, accum: int) -> int:
    """``accum``, or for a DTensor batch ``gcd(accum, rows per rank)``."""
    from ..dist.sharding import is_dtensor
    x = next(iter(batch.values()))
    return math.gcd(accum, x.to_local().shape[0]) if is_dtensor(x) else accum


def _microbatch(x, accum: int, i: int):
    """Microbatch ``i`` of ``accum`` along dim 0: rows ``[i·B/accum,
    (i+1)·B/accum)``.  A DTensor batch split over ranks along dim 0 is
    split on each rank (its local rows), as data-parallel microbatching
    runs: the microbatches hold other rows, and the same rows in all."""
    from ..dist.sharding import is_dtensor
    if is_dtensor(x):
        from torch.distributed.tensor import DTensor
        local = x.to_local()
        part = local.reshape((accum, local.shape[0] // accum) + local.shape[1:])[i]
        return DTensor.from_local(part, x.device_mesh, x.placements, run_check=False)
    return x.reshape((accum, x.shape[0] // accum) + x.shape[1:])[i]


def _resolve_compress(compress):
    """``"auto"`` / policy / mode string / per-leaf tree → ef_psum_grads mode."""
    from ..dist.policy import resolve_policy
    if isinstance(compress, str):
        return resolve_policy(compress)
    return compress


def _pmean_metrics(loss, metrics, group, n):
    """The group means of the loss and the metrics (``lax.pmean`` of each):
    one sum all-reduce of all of them, then a multiply by the f32 ``1/n``
    (as the compiled reference divides by a constant)."""
    from ..dist import wire
    names = list(metrics)
    vals = [loss] + [metrics[k] for k in names]
    flat = torch.cat([v.reshape(-1).to(torch.float32) for v in vals])
    flat = wire.all_reduce(flat, group, leaf="_metrics") * torch.tensor(
        1.0 / n, dtype=torch.float32, device=flat.device)
    out, i = [], 0
    for v in vals:
        out.append(flat[i:i + v.numel()].reshape(v.shape).to(v.dtype))
        i += v.numel()
    return out[0], dict(zip(names, out[1:]))


def _rank_block(batch, n, rank):
    """Block ``rank`` of ``n`` of every tensor of the global batch, along
    dim 0 (``shard_map``'s ``P(axis)`` in_spec)."""
    local = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch {k!r} of {v.shape[0]} rows does not split over "
                             f"{n} ranks")
        b = v.shape[0] // n
        local[k] = v[rank * b:(rank + 1) * b]
    return local


def make_dp_train_step(loss_fn, optimizer: Optimizer, group=None, *,
                       compress="bf16", clip_norm=None):
    """Explicit data-parallel step with compressed gradient reduction.

    Every rank of ``group`` (``None``: the default process group) holds
    the whole state and is handed the **global** batch; it keeps block
    ``rank`` of dim 0 (``shard_map``'s ``P(axis)``), takes its gradients
    there and reduces them with bf16/int8 error feedback
    (``dist.compress.ef_psum_grads``, state carried in ``state["err"]``).
    Loss and metrics are group means.  ``compress`` is a mode string,
    ``"auto"``, a ``CompressionPolicy``, or a per-leaf mode tree.  The
    per-rank update math is identical, so the replicas stay bitwise
    consistent without a re-broadcast.
    """
    from ..dist.compress import ef_psum_grads
    compress = _resolve_compress(compress)
    grads_of = value_and_grad(loss_fn)

    def step(state, batch):
        g = dist.group.WORLD if group is None else group
        n, rank = dist.get_world_size(g), dist.get_rank(g)
        (loss, metrics), grads = grads_of(state["params"], _rank_block(batch, n, rank))
        grads, new_err = ef_psum_grads(grads, state["err"], group=g, mode=compress)
        loss, metrics = _pmean_metrics(loss, metrics, g, n)
        if clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            metrics = dict(metrics, grad_norm=gnorm)
        with span("repro.train.optimizer"):
            new_params, new_opt = optimizer.update(grads, state["opt"], state["params"],
                                                   state["step"])
        new_state = {"params": new_params, "opt": new_opt, "step": state["step"] + 1,
                     "err": new_err}
        return new_state, dict(metrics, loss=loss)

    return step


def init_dp_state(params, optimizer: Optimizer, compress=None):
    """State for ``make_dp_train_step``.  Pass the same ``compress`` policy
    as the step so error-feedback state is allocated only for compressed
    leaves."""
    from ..dist.compress import init_error_state
    err = init_error_state(params,
                           _resolve_compress(compress) if compress is not None else None)
    state = init_state(params, optimizer)
    state["err"] = err
    return state


# --------------------------------------------------------------- FSDP path


def _group_of(group):
    if not dist.is_initialized():
        raise RuntimeError("the FSDP step runs over a torch.distributed process group, and "
                           "none is initialized: call torch.distributed.init_process_group")
    return dist.group.WORLD if group is None else group


def fsdp_plan(params_like, optimizer: Optimizer, mesh, *, policy="auto", axis: str = "data"):
    """Per-leaf FSDP plan: ``[(path, shape, mode, scatter_dim | None)]``.

    ``mesh`` is the axis sizes (``dist.sharding.axis_sizes``: a mapping,
    an int, or a process group).  The scatter dim is the first
    ``sharding.scatter_dims`` candidate along which every optimizer-state
    leaf of that parameter is sliceable (its size there equals the
    parameter's — row-wise Adagrad's ``(rows, 1)`` accumulator admits dim
    0 only, Adafactor's factored stats admit none, so those leaves fall
    back to the replicated all-reduce path)."""
    from ..dist.compress import resolve_modes
    from ..dist.sharding import scatter_dims
    from ..optim.optimizers import leaf_paths, state_structs
    modes = resolve_modes(params_like, _resolve_compress(policy))
    plan = []
    for path, leaf, mode, entry in zip(leaf_paths(params_like), tree.leaves(params_like), modes,
                                       state_structs(optimizer, params_like)):
        shape = tuple(leaf.shape)
        dim = None
        for d in scatter_dims(path, shape, mesh, axis):
            if all(s.dim() > d and s.shape[d] == shape[d] for s in tree.leaves(entry)):
                dim = d
                break
        plan.append((path, shape, mode, dim))
    return plan


def _gather_dtype(param_gather_dtype) -> torch.dtype:
    names = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    dt = names.get(param_gather_dtype, param_gather_dtype)
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"param_gather_dtype must be float32 or bfloat16, "
                         f"got {param_gather_dtype!r}")
    return dt


def make_fsdp_train_step(loss_fn, optimizer: Optimizer, group, params_like, *,
                         policy="auto", clip_norm=None, axis: str = "data",
                         param_gather_dtype="float32"):
    """Reduce-scatter FSDP step over ``group`` (``None``: the default
    process group, which must be initialized): compressed gradients land
    as shards.

    Per leaf (scatter dim from ``fsdp_plan``): reduce-scatter the
    compressed gradient (``dist.compress._reduce_scatter_leaf``), apply the
    optimizer to this rank's parameter shard against its **sharded
    optimizer state** (per-rank optimizer memory ÷ N), then all-gather the
    updated shards back into replicated parameters for the next forward.
    Leaves with no viable scatter dim take the replicated compressed
    all-reduce path; the two coexist in one step.  Every rank is handed
    the global batch and keeps block ``rank`` of it.

    The state (``init_fsdp_state``) holds the parameters whole, each
    optimizer-state leaf sliced on its parameter's scatter dim, and this
    rank's row ``(1, *shape)`` of the reference's per-device residuals
    ``(n, *shape)`` (``(1,)`` for an uncompressed leaf).  Supported
    optimizers are those whose update is element-wise or row-preserving
    along the scatter dim (SGD / Adagrad / Adam; row-wise Adagrad scatters
    rows); Adafactor leaves fall back to the all-reduce.

    ``param_gather_dtype="bfloat16"`` halves the parameter all-gather's
    bytes: updated shards cross as bf16 and each rank then overwrites its
    own slice with its exact f32 shard, so the master shard never loses
    precision; only the copies of other ranks' shards are bf16-rounded.
    ``clip_norm`` clips by the global norm, shard-aware: the scattered
    leaves' shard energies are summed over the group (one scalar
    all-reduce), the replicated leaves' are the same on every rank.
    """
    from ..dist import wire
    from ..dist.compress import _reduce_leaf, _reduce_scatter_leaf
    from ..dist.sharding import axis_sizes
    g = _group_of(group)
    n = axis_sizes(g, axis)[axis]
    gather_dtype = _gather_dtype(param_gather_dtype)
    plan = fsdp_plan(params_like, optimizer, {axis: n}, policy=policy, axis=axis)
    grads_of = value_and_grad(loss_fn)

    def step(state, batch):
        rank = dist.get_rank(g)
        (loss, metrics), grads = grads_of(state["params"], _rank_block(batch, n, rank))
        red, new_err, p_local = [], [], []
        for gr, p, e_blk, (path, shape, mode, dim) in zip(
                tree.leaves(grads), tree.leaves(state["params"]), tree.leaves(state["err"]),
                plan):
            e = e_blk.reshape(e_blk.shape[1:])      # drop the rank dim
            if dim is None:
                r, ne = _reduce_leaf(gr, e, g, mode, leaf=path)
                r, p_loc = r.to(torch.float32), p
            else:
                r, ne = _reduce_scatter_leaf(gr, e, g, mode, dim, leaf=path)
                shard = shape[dim] // n
                p_loc = p.narrow(dim, rank * shard, shard)
            red.append(r)
            new_err.append(ne.reshape((1,) + tuple(ne.shape)))
            p_local.append(p_loc)
        del grads

        if clip_norm is not None:
            scattered = [torch.sum(torch.square(r)) for r, pl in zip(red, plan)
                         if pl[3] is not None]
            scat = (wire.all_reduce(sum(scattered[1:], scattered[0]), g, leaf="_clip")
                    if scattered else 0.0)
            rep = sum(torch.sum(torch.square(r)) for r, pl in zip(red, plan) if pl[3] is None)
            gnorm = torch.sqrt(scat + rep)
            scale = torch.clamp(clip_norm / (gnorm + 1e-9), max=1.0)
            red = [r * scale for r in red]
            metrics = dict(metrics, grad_norm=gnorm)

        params = state["params"]
        with span("repro.train.optimizer"):
            new_p_local, new_opt = optimizer.update(tree.unflatten(params, red), state["opt"],
                                                    tree.unflatten(params, p_local),
                                                    state["step"])
        new_params = []
        for np_loc, (path, shape, _, dim) in zip(tree.leaves(new_p_local), plan):
            if dim is None:
                new_params.append(np_loc)
            elif gather_dtype == torch.bfloat16:
                full = wire.all_gather(np_loc.to(torch.float32).to(torch.bfloat16), g,
                                       dim=dim, leaf=path).to(np_loc.dtype)
                # this rank's master shard stays exact
                shard = shape[dim] // n
                full.narrow(dim, rank * shard, shard).copy_(np_loc)
                new_params.append(full)
            else:
                new_params.append(wire.all_gather(np_loc, g, dim=dim, leaf=path))
        loss, metrics = _pmean_metrics(loss, metrics, g, n)
        new_state = {"params": tree.unflatten(params, new_params), "opt": new_opt,
                     "step": state["step"] + 1, "err": tree.unflatten(params, new_err)}
        return new_state, dict(metrics, loss=loss)

    step.plan = plan
    return step


def _local_shards(plan, rank, n):
    """This rank's ``Shard`` of each leaf's optimizer state (the whole leaf
    where the leaf is not scattered)."""
    from ..dist.sharding import REPLICATED, Shard
    return [REPLICATED if dim is None else Shard(dim, rank, n) for (_, _, _, dim) in plan]


def init_fsdp_state(params, optimizer: Optimizer, group=None, *, policy="auto",
                    axis: str = "data"):
    """State for ``make_fsdp_train_step`` on this rank of ``group``: the
    parameters whole, the optimizer state of each leaf's shard (initialised
    on the shard: every supported optimizer's state is zeros shaped like
    its parameter, or row-wise along dim 0), and this rank's residual row,
    ``(1, *shape)`` for a compressed leaf, ``(1,)`` otherwise (the
    reference's ``(n,)`` placeholder, one entry per device)."""
    from ..dist.compress import resolve_modes
    g = _group_of(group)
    n, rank = dist.get_world_size(g), dist.get_rank(g)
    plan = fsdp_plan(params, optimizer, {axis: n}, policy=policy, axis=axis)
    shards = _local_shards(plan, rank, n)
    local = tree.unflatten(params, [s.take(p) for s, p in zip(shards, tree.leaves(params))])
    modes = resolve_modes(params, _resolve_compress(policy))
    err = [torch.zeros((1,) if m == "none" else (1,) + tuple(p.shape), dtype=torch.float32,
                       device=p.device)
           for p, m in zip(tree.leaves(params), modes)]
    state = init_state(params, optimizer)
    state["opt"] = optimizer.init(local)
    state["err"] = tree.unflatten(params, err)
    return state


def fsdp_state_shardings(state_like, plan, rank: int, n: int):
    """The ``shardings`` tree for ``ckpt.restore`` of an FSDP state onto
    rank ``rank`` of ``n`` (``state_like``: a state of the same structure,
    e.g. this rank's ``init_fsdp_state``): parameters and step whole, each
    optimizer-state leaf's block along its parameter's scatter dim, and
    block ``rank`` of every residual's leading (rank) dim.  ``n`` may differ
    from the world that saved (the elastic restore)."""
    from ..dist.sharding import REPLICATED, Shard
    opt = [tree.tree_map(lambda _, s=s: s, entry)
           for entry, s in zip(state_like["opt"], _local_shards(plan, rank, n))]
    return {"params": tree.tree_map(lambda _: REPLICATED, state_like["params"]),
            "opt": opt, "step": REPLICATED,
            "err": tree.tree_map(lambda _: Shard(0, rank, n), state_like["err"])}


def gather_fsdp_state(state, plan, group=None):
    """The full-leaf form of an FSDP state, for a checkpoint: each
    optimizer-state shard gathered along its scatter dim and the residual
    rows stacked in rank order (``(n, *shape)``), so its leaves have the
    shapes of the reference's ``init_fsdp_state``.  Every rank calls it
    (collectives, logged under ``_checkpoint``); each gets the whole
    state."""
    from ..dist import wire
    g = _group_of(group)

    def full(x, dim):
        return wire.all_gather(x, g, dim=dim, leaf="_checkpoint")

    opt = [entry if dim is None else tree.tree_map(lambda x, d=dim: full(x, d), entry)
           for entry, (_, _, _, dim) in zip(state["opt"], plan)]
    err = tree.tree_map(lambda e: full(e, 0), state["err"])
    return {"params": state["params"], "opt": opt, "step": state["step"], "err": err}


def _block_until_ready(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


class Trainer:
    def __init__(self, train_step, cfg: TrainConfig, *,
                 batch_at: Callable[[int], Any], obs=None, step_wire=None):
        """``train_step`` from ``make_train_step`` or ``make_dp_train_step``;
        ``batch_at(step)`` the batch of a step.  ``obs`` (a
        ``repro_torch.obs.Obs``) turns on per-step spans and counters;
        ``step_wire`` is an accounted wire-byte report for one step
        (``dist.accounting.grad_wire_bytes`` / ``dp_step_wire_bytes``
        output): its per-leaf entries become per-leaf wire counters
        incremented every step, and what the total holds beyond them (the
        scalar means) an ``_other/aggregate`` one.  It counts only with
        ``obs``.  Both default off; the obs-off loop is unchanged."""
        self.train_step = train_step
        self.cfg = cfg
        self.batch_at = batch_at
        self.checkpointer = (ckpt.AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.keep)
                             if cfg.ckpt_dir else None)
        self.straggler_events: list[tuple[int, float]] = []
        self._obs = obs
        if obs is not None:
            self._h_step = obs.histogram("train_step_seconds", "per-step wall time").labels()
            self._c_steps = obs.counter("train_steps_total", "optimizer steps taken").labels()
            self._c_strag = obs.counter(
                "train_straggler_events_total",
                "steps slower than watchdog_factor x running median").labels()
            self._wire_handles: list[tuple[Any, float]] = []
            if step_wire is not None:
                c = obs.counter("train_wire_bytes_total",
                                "accounted collective wire bytes (per leaf)")
                for e in step_wire.get("per_leaf") or []:
                    self._wire_handles.append((c.labels(leaf=e["path"], mode=e["mode"]),
                                               float(e["wire_bytes"])))
                accounted = sum(b for _, b in self._wire_handles)
                rest = float(step_wire.get("total_bytes", 0.0)) - accounted
                if rest > 0:  # scalar means, or a report with no per-leaf entries
                    self._wire_handles.append(
                        (c.labels(leaf="_other", mode="aggregate"), rest))

    def resume_or(self, state):
        """Resume from the newest valid checkpoint, else the given state."""
        if self.cfg.ckpt_dir:
            _, restored, _ = ckpt.restore_latest(self.cfg.ckpt_dir, state)
            if restored is not None:
                return restored
        return state

    def run(self, state, *, fail_at_step: Optional[int] = None):
        """Steps from ``state["step"]`` to ``num_steps``; returns the final
        state and ``[(step, loss)]`` at the log steps.  Each step ends in
        one synchronize; the loss is read back only at log steps.  With
        ``obs.tracer``, that tracer is active for the run."""
        tracer = None if self._obs is None else self._obs.tracer
        with contextlib.nullcontext() if tracer is None else tracer.active():
            return self._run(state, fail_at_step)

    def _run(self, state, fail_at_step):
        cfg = self.cfg
        history = []
        durations: list[float] = []
        start = int(state["step"])
        for step in range(start, cfg.num_steps):
            if fail_at_step is not None and step == fail_at_step:
                raise SimulatedFailure(f"injected failure at step {step}")
            batch = self.batch_at(step)
            t0 = time.monotonic()
            state, metrics = self.train_step(state, batch)
            _block_until_ready(metrics["loss"])
            dt = time.monotonic() - t0
            straggled = False
            if len(durations) >= 5:
                med = statistics.median(durations[-50:])
                if dt > cfg.watchdog_factor * med:
                    self.straggler_events.append((step, dt / med))
                    straggled = True
            durations.append(dt)
            if self._obs is not None:
                self._h_step.observe(dt)
                self._c_steps.inc()
                if straggled:
                    self._c_strag.inc()
                for h, b in self._wire_handles:
                    h.inc(b)
                if self._obs.tracer is not None:
                    self._obs.tracer.complete("train_step", t0, dt, step=step)
            if step % cfg.log_every == 0 or step == cfg.num_steps - 1:
                history.append((step, float(metrics["loss"])))
            if self.checkpointer and (step + 1) % cfg.ckpt_every == 0:
                self.checkpointer.save(step + 1, state)
        if self.checkpointer:
            self.checkpointer.save(cfg.num_steps, state)
            self.checkpointer.wait()
        return state, history

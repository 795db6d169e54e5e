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
  ``train_step`` event; with ``obs=None`` none of it runs.

* **gradient compression** — ``make_dp_train_step`` reduces gradients
  over a ``torch.distributed`` process group with bf16/int8 error
  feedback, uniform or per leaf through a ``CompressionPolicy``
  (``repro_torch.dist.compress`` / ``dist.policy``); with ``step_wire=``
  the ``Trainer`` counts each leaf's accounted wire bytes per step.

The step is functional, as the reference's jitted step is: it returns a
new state of plain tensors (no autograd graph) and leaves the old one as
it was.  Gradients come from ``torch.autograd.grad`` on detached aliases
of the parameter leaves (``value_and_grad``), dense for every leaf as
``jax.grad``'s are.  The FSDP step waits for the multi-GPU port (ROADMAP,
modules to port: item 16b).
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from .. import tree
from ..ckpt import checkpoint as ckpt
from ..optim.optimizers import Optimizer, clip_by_global_norm

__all__ = ["TrainConfig", "init_state", "make_train_step", "make_dp_train_step",
           "init_dp_state", "value_and_grad", "Trainer", "SimulatedFailure"]


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
    reach) and every returned tensor detached."""

    def fn(params, batch):
        flat = tree.leaves(params)
        live = [p.detach().requires_grad_(True) for p in flat]
        with torch.enable_grad():
            loss, metrics = loss_fn(tree.unflatten(params, live), batch)
            grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (loss.detach(), metrics), tree.unflatten(params, list(grads))

    return fn


def make_train_step(loss_fn, optimizer: Optimizer, *, clip_norm=None,
                    accum: int = 1, accum_dtype=torch.float32):
    """The step: grads → (clip) → optimizer → new state.

    ``accum`` > 1 splits the global batch into ``accum`` microbatches along
    dim 0 and runs them one after another, accumulating the gradients in
    ``accum_dtype``; loss and metrics are microbatch means.
    """
    grads_of = value_and_grad(loss_fn)

    def step(state, batch):
        params = state["params"]
        if accum == 1:
            (loss, metrics), grads = grads_of(params, batch)
        else:
            g_acc = [torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
                     for p in tree.leaves(params)]
            loss_sum, metricss = 0.0, []
            for i in range(accum):
                micro = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])[i]
                         for k, v in batch.items()}
                (mloss, mmetrics), g = grads_of(params, micro)
                g_acc = [a + b.to(accum_dtype) for a, b in zip(g_acc, tree.leaves(g))]
                loss_sum = loss_sum + mloss
                metricss.append(mmetrics)
            grads = tree.unflatten(params, [g / accum for g in g_acc])
            loss = loss_sum / accum
            metrics = {k: torch.stack([m[k] for m in metricss]).mean() for k in metricss[0]}
        if clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            metrics = dict(metrics, grad_norm=gnorm)
        new_params, new_opt = optimizer.update(grads, state["opt"], params, state["step"])
        new_state = {"params": new_params, "opt": new_opt, "step": state["step"] + 1}
        return new_state, dict(metrics, loss=loss)

    return step


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
        local = {}
        for k, v in batch.items():
            if v.shape[0] % n:
                raise ValueError(f"batch {k!r} of {v.shape[0]} rows does not split over "
                                 f"{n} ranks")
            b = v.shape[0] // n
            local[k] = v[rank * b:(rank + 1) * b]
        (loss, metrics), grads = grads_of(state["params"], local)
        grads, new_err = ef_psum_grads(grads, state["err"], group=g, mode=compress)
        loss, metrics = _pmean_metrics(loss, metrics, g, n)
        if clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            metrics = dict(metrics, grad_norm=gnorm)
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
        one synchronize; the loss is read back only at log steps."""
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

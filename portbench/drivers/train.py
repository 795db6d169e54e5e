"""Traffic kind ``train``: training at a fixed global batch.

Set-up makes the f32 parameters and a pool of ``pool`` batches of
``batch`` rows on the device from the seed (one draw of the frozen stream,
cut into the batches), builds one training step, ``make_train_step`` over
the port's loss and the configuration's optimizer, and one ``Trainer``
feeding it batch ``step mod pool``.  That same object takes the first
``checked_steps`` steps in set-up, on batches whose rows all differ, and
then the window: ``Trainer.run`` in chunks of ``chunk_steps`` steps until
the seconds are spent, every step ending in the synchronise that
``Trainer.run`` makes.

``correct``: once the window has closed and the program's state is freed,
the plain reference takes the same first steps from the same parameters
(made again from the seed) on the same batches, in f32 with TF32 off, and
three numbers compare the two:

  * ``loss_gap``: the largest relative gap of a step's loss;
  * ``grad_gap``: the worst leaf's gap between the norms of the first
    gradient, the program's worked out from its optimizer state after one
    step (AMSGrad's ``m / (1 − b1)``, Adagrad's ``sqrt(acc)``);
  * ``step_gap``: the worst leaf's gap between the norms of the
    parameters' change over the checked steps, over the leaves whose
    reference gradient is at least a thousandth of the median leaf's.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import time

import torch

from portbench.lib import compare
from portbench.lib import params as P
from portbench.lib import precision, stream, trace
from portbench.lib import tree as T
from portbench.lib.ranges import maybe as maybe_range
from portbench.lib.stages import Stages
from portbench.reference import train as ref_train

STEP, OPTIMIZER = "portbench.step", "portbench.optimizer"
MOVED = 1e-3       # a leaf counts in step_gap when its reference gradient is above this share


class _Ranged:
    """The optimizer the harness hands to ``make_train_step``: the port's,
    inside a ``portbench.optimizer`` range while the stretch is traced."""

    def __init__(self, opt):
        self.opt, self.on = opt, False

    def init(self, params):
        return self.opt.init(params)

    def update(self, *args):
        with maybe_range(self.on, OPTIMIZER):
            return self.opt.update(*args)


def first_grad_norms(kind: str, opt_state: list) -> list:
    """Each leaf's first-gradient norm from the optimizer state after one
    step."""
    if kind == "amsgrad":
        return [float(torch.linalg.vector_norm(s["m"])) / (1 - 0.9) for s in opt_state]
    if kind == "adagrad":
        return [math.sqrt(float(s["acc"].sum())) for s in opt_state]
    raise ValueError(f"optimizer {kind!r}")


class Bench:
    def __init__(self, cell, seed: int, device="cuda", fault: str | None = None,
                 control: bool = False):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.conf, self.traffic, self.model = cell.conf, cell.traffic, cell.model
        self.fault, self.control = fault, control
        self.batch = self.traffic["batch"]
        self.checked = self.traffic["checked_steps"]
        if self.conf["optimizer"]["kind"] == "amsgrad" and self.conf["optimizer"]["b1"] != 0.9:
            raise ValueError("first_grad_norms reads AMSGrad's m with b1 = 0.9")

    # ---------------------------------------------------------------- set-up
    def _params(self):
        return P.make(self.model.layout(self.conf), self.seed, self.device)

    def _pool(self):
        s, n = self.traffic["stream"], self.traffic["pool"]
        spec = stream.CriteoSpec(table_sizes=tuple(self.conf["table_sizes"]),
                                 dense_dim=self.conf["dense_dim"], zipf=s["zipf"],
                                 noise=s["noise"])
        draw = stream.batch_at(self.seed, 0, n * self.batch, spec, self.device)
        return [dict(zip(draw, parts)) for parts in
                zip(*(torch.split(v, self.batch) for v in draw.values()))]

    def setup(self) -> None:
        from repro_torch.train.loop import TrainConfig, Trainer, init_state, make_train_step

        clock = Stages()
        precision.state(self.conf)
        self.pool = self._pool()
        clock("pool")
        params = self._params()
        self.fingerprint = P.fingerprint(params)
        clock("parameters")
        if self.control:
            return
        port = self.model.port(self.conf, self.device)
        self.ranges = port.ranges
        self.opt = _Ranged(port.optimizer)
        step = make_train_step(_faulty_loss(port.loss_fn, self.fault), self.opt)
        self.ranged = False

        def ranged(state, batch):
            with maybe_range(self.ranged, STEP):
                new, metrics = step(state, batch)
            return (state if self.fault == "unchanged" else new), metrics

        self.trainer = Trainer(ranged, TrainConfig(num_steps=1, log_every=1),
                               batch_at=lambda s: self.pool[s % len(self.pool)])
        clock("program")
        state, history = self.trainer.run(init_state(params, self.opt))
        self.grad_norms = first_grad_norms(self.conf["optimizer"]["kind"], state["opt"])
        state, more = self._run(state, self.checked)
        self.losses = [loss for _, loss in history + more]
        self.change = [float(torch.linalg.vector_norm(a - b)) for (_, a), (_, b) in
                       zip(T.items(state["params"]), T.items(params))]
        self.state = state
        clock("checked steps")
        self.stages = clock.seconds

    def _run(self, state, until: int, log_every: int = 1):
        self.trainer.cfg = dataclasses.replace(self.trainer.cfg, num_steps=until,
                                               log_every=log_every)
        return self.trainer.run(state)

    # ---------------------------------------------------------------- window
    def window(self, seconds: float) -> dict:
        if self.control:        # the control's steps are the reference's, taken in the check
            return {"attempted": 0, "failed": 0, "wall_s": 0.0, "samples": 0,
                    "metrics": {"samples_per_s": 0.0}}
        chunk = self.traffic["chunk_steps"]
        step = start = int(self.state["step"])
        losses = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.state, history = self._run(self.state, step + chunk, log_every=chunk)
            losses += [loss for _, loss in history]
            step += chunk
        wall = time.perf_counter() - t0
        steps = step - start
        samples = steps * self.batch
        return {"attempted": steps, "failed": sum(not math.isfinite(x) for x in losses),
                "wall_s": wall, "samples": samples,
                "metrics": {"samples_per_s": samples / wall}}

    def traced(self):
        """``trace_steps`` steps under the profiler, each in a
        ``portbench.step`` range, the optimizer in ``portbench.optimizer``."""
        n = self.traffic["trace_steps"]
        step = int(self.state["step"])
        self.ranged = self.opt.on = True
        try:
            with self.ranges():
                (self.state, _), tr = trace.capture(
                    lambda: self._run(self.state, step + n, n), self.device)
        finally:
            self.ranged = self.opt.on = False
        return tr, {"steps": n}

    # ---------------------------------------------------------------- check
    def release(self) -> None:
        for name in ("state", "trainer", "opt"):
            self.__dict__.pop(name, None)

    def _reference(self, params, tf32: bool):
        o = self.conf["optimizer"]
        batches = self.pool[:self.checked]
        if tf32:
            with precision.tf32():
                return ref_train.steps(self.model.reference_forward, self.conf, params, batches, o)
        return ref_train.steps(self.model.reference_forward, self.conf, params, batches, o)

    def check(self) -> dict:
        params = self._params()
        if P.fingerprint(params) != self.fingerprint:
            raise RuntimeError("the parameters made again from the seed differ from set-up's")
        want = self._reference(params, tf32=False)
        if self.control:
            got = self._reference(params, tf32=True)
            self.losses, self.grad_norms, self.change = got.losses, got.grad_norms, got.change
        med = statistics.median(want.grad_norms)
        moved = [g >= MOVED * med for g in want.grad_norms]
        self.notes = {"leaves_left_out_of_step_gap": len(moved) - sum(moved),
                      "loss_first_step": want.losses[0]}
        return {"loss_gap": compare.rel_gap(self.losses, want.losses),
                "grad_gap": compare.worst_leaf_gap(self.grad_norms, want.grad_norms),
                "step_gap": compare.worst_leaf_gap(self.change, want.change, moved)}


def _faulty_loss(loss_fn, fault):
    """``loss_fn`` with a planted fault: ``half`` takes the mean over the
    first half of the batch.  (``unchanged``, a step that returns its
    state, is planted in the step.)"""
    if fault in (None, "unchanged"):
        return loss_fn
    if fault == "half":
        def half(p, batch):
            n = next(iter(batch.values())).shape[0]
            return loss_fn(p, {k: v[:n // 2] for k, v in batch.items()})
        return half
    raise ValueError(f"train has no fault {fault!r}")

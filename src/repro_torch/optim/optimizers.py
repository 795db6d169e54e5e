"""Optimizers as functions on the parameter tree (the paper trains with
Adagrad and AMSGrad, §5.2).

Every optimizer is a pair of leaf-level functions, ``init_leaf(p)`` and
``update_leaf(g, s, p, step)``; the tree-level ``init`` / ``update``
flatten the tree once (``repro_torch.tree``, in ``jax.tree.leaves`` order)
and map over the leaves.  The state is a list with one dict per leaf,
keyed as the reference keys it (``acc``, ``m``, ``v``, ``vmax``, ``vr``,
``vc``), so checkpoints and the ``partitioned`` path rule map one to one
onto the JAX package's.  ``torch.optim`` is not used: it has no row-wise
Adagrad and no per-path dispatch.

Updates are functional (new tensors, the old state untouched) and run
under ``torch.no_grad()``.  State is f32; a parameter's update is added
in f32 and cast once to the parameter's dtype.  ``step`` is a Python int
or a 0-d int32 tensor; bias corrections and schedules compute from it as
the reference does (an int step in Python floats, a tensor step in f32).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from .. import tree

__all__ = ["sgd", "adagrad", "rowwise_adagrad", "adam", "adafactor",
           "partitioned", "clip_by_global_norm", "cosine_schedule",
           "constant_schedule", "global_norm", "Optimizer", "leaf_paths",
           "state_structs"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init_leaf: Callable    # p -> leaf_state (dict of tensors)
    update_leaf: Callable  # (g, s, p, step) -> (new_p, new_s)

    def _rule(self, path):
        return self

    @torch.no_grad()
    def init(self, params):
        return [self._rule(path).init_leaf(p)
                for path, p in zip(leaf_paths(params), tree.leaves(params))]

    @torch.no_grad()
    def update(self, grads, state, params, step):
        leaves_g = tree.leaves(grads)
        out = [self._rule(path).update_leaf(g, s, p, step)
               for path, g, s, p in zip(leaf_paths(params), leaves_g, state,
                                        tree.leaves(params))]
        return tree.unflatten(params, [o[0] for o in out]), [o[1] for o in out]


def constant_schedule(lr: float):
    return lambda step: lr


def _f32(step):
    return torch.as_tensor(step, dtype=torch.float32)


def cosine_schedule(lr: float, warmup: int, total: int, floor: float = 0.1):
    def fn(step):
        s = _f32(step)
        warm = lr * torch.clamp((s + 1) / max(warmup, 1), max=1.0)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(s < warmup, warm, lr * cos)
    return fn


def global_norm(grads):
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree.leaves(grads)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree.tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), norm


def _sched(lr):
    return lr if callable(lr) else constant_schedule(lr)


def _step_p(p, u):
    """``p + u`` in f32, cast to ``p``'s dtype.  ``u`` is an f32 temporary of
    the caller's and takes the sum in place (the same bits as
    ``p.to(float32) + u``: the sum is commutative)."""
    return u.add_(p).to(p.dtype)


def _zeros(shape, p):
    return torch.zeros(shape, dtype=torch.float32, device=p.device)


def sgd(lr, momentum: float = 0.0, weight_decay: float = 0.0):
    sched = _sched(lr)

    def init_leaf(p):
        return {"m": _zeros(p.shape, p)} if momentum else {}

    def update_leaf(g, s, p, step):
        g32 = g.to(torch.float32) + weight_decay * p.to(torch.float32)
        if momentum:
            m = momentum * s["m"] + g32
            return _step_p(p, -sched(step) * m), {"m": m}
        return _step_p(p, -sched(step) * g32), s

    return Optimizer(init_leaf, update_leaf)


def adagrad(lr=1e-2, eps: float = 1e-10):
    """Duchi et al. 2011 — the paper's default optimizer."""
    sched = _sched(lr)

    def init_leaf(p):
        return {"acc": _zeros(p.shape, p)}

    def update_leaf(g, s, p, step):
        g32 = g.to(torch.float32)
        acc = s["acc"] + torch.square(g32)
        return _step_p(p, -sched(step) * g32 / (torch.sqrt(acc) + eps)), {"acc": acc}

    return Optimizer(init_leaf, update_leaf)


def rowwise_adagrad(lr=1e-2, eps: float = 1e-10):
    """Adagrad with one accumulator per table row (production-DLRM trick).

    For a (rows, D) table the state is (rows, 1) — 1/D the optimizer
    memory.  Non-2D leaves fall back to element-wise Adagrad.
    """
    sched = _sched(lr)

    def init_leaf(p):
        return {"acc": _zeros((p.shape[0], 1) if p.dim() == 2 else p.shape, p)}

    def update_leaf(g, s, p, step):
        g32 = g.to(torch.float32)
        if g.dim() == 2:
            acc = s["acc"] + torch.mean(torch.square(g32), dim=1, keepdim=True)
        else:
            acc = s["acc"] + torch.square(g32)
        return _step_p(p, -sched(step) * g32 / (torch.sqrt(acc) + eps)), {"acc": acc}

    return Optimizer(init_leaf, update_leaf)


def adam(lr=1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         amsgrad: bool = False, weight_decay: float = 0.0):
    """Adam / AMSGrad (Reddi et al. 2019) — the paper's second optimizer."""
    sched = _sched(lr)

    def init_leaf(p):
        s = {"m": _zeros(p.shape, p), "v": _zeros(p.shape, p)}
        if amsgrad:
            s["vmax"] = _zeros(p.shape, p)
        return s

    def update_leaf(g, s, p, step):
        t = step + 1       # an int32 tensor step gives f32 powers below, as in the reference
        g32 = g.to(torch.float32)
        m = b1 * s["m"] + (1 - b1) * g32
        v = b2 * s["v"] + (1 - b2) * torch.square(g32)
        ns = {"m": m, "v": v}
        if amsgrad:
            vmax = torch.maximum(s["vmax"], v)
            ns["vmax"] = vmax
            vhat = vmax
        else:
            vhat = v
        mhat = m / (1 - b1 ** t)
        vhat = vhat / (1 - b2 ** t)
        u = -sched(step) * mhat / (torch.sqrt(vhat) + eps)
        if weight_decay:
            u = u - sched(step) * weight_decay * p.to(torch.float32)
        return _step_p(p, u), ns

    return Optimizer(init_leaf, update_leaf)


def adafactor(lr=1e-2, eps: float = 1e-30, clip_threshold: float = 1.0,
              decay: float = 0.8):
    """Factored second moment: O(rows+cols) state for ≥2-D leaves.

    The leaf-sized f32 work runs in place (the same operations in the same
    order as the out-of-place formula, so the same values): at most two
    leaf-sized f32 temporaries are alive at once, which is what lets a
    stacked expert leaf of billions of elements take its step on one card."""
    from ..dist.sharding import settle
    sched = _sched(lr)

    def init_leaf(p):
        if p.dim() >= 2:
            return {"vr": _zeros(p.shape[:-1], p),
                    "vc": _zeros(p.shape[:-2] + p.shape[-1:], p)}
        return {"v": _zeros(p.shape, p)}

    def update_leaf(g, s, p, step):
        t = step + 1
        beta = 1.0 - (t.to(torch.float32) if torch.is_tensor(t) else float(t)) ** (-decay)
        g32 = g.to(torch.float32, copy=True)
        g2 = torch.square(g32).add_(eps)
        if g.dim() >= 2:
            # on DTensors the means' pending reductions settle before they
            # meet the state and the in-place steps below
            vr = settle(beta * s["vr"] + (1 - beta) * settle(g2.mean(dim=-1)))
            vc = settle(beta * s["vc"] + (1 - beta) * settle(g2.mean(dim=-2)))
            del g2
            ns = {"vr": vr, "vc": vc}
            denom = (vr[..., None] * vc[..., None, :]).div_(
                torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)[..., None])
            u = g32.div_(denom.clamp_(min=eps).sqrt_())
            del denom
        else:
            v = beta * s["v"] + (1 - beta) * g2
            del g2
            ns = {"v": v}
            u = g32.div_(torch.sqrt(torch.clamp(v, min=eps)))
        rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
        u.div_(torch.clamp(rms / clip_threshold, min=1.0))
        return _step_p(p, u.mul_(-sched(step))), ns

    return Optimizer(init_leaf, update_leaf)


def leaf_paths(params) -> list[str]:
    """'/'-joined string path per leaf, in ``jax.tree.leaves`` order."""
    return ["/".join(str(k) for k in path) for path, _ in tree.flatten_with_path(params)]


def state_structs(optimizer: Optimizer, params_like):
    """The optimizer state's shapes and dtypes without materialising it:
    ``optimizer.init`` on ``meta`` tensors shaped like ``params_like``
    (the reference's ``jax.eval_shape``).  One entry per parameter leaf,
    in leaf order."""
    meta = tree.tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"),
                         params_like)
    return optimizer.init(meta)


@dataclasses.dataclass(frozen=True)
class _Partitioned(Optimizer):
    rules: tuple = ()
    default: Optimizer | None = None

    def _rule(self, path):
        for pred, opt in self.rules:
            if pred(path):
                return opt
        return self.default


def partitioned(rules, default: Optimizer):
    """Per-leaf optimizer dispatch by path predicate.

    ``rules``: [(predicate(path) -> bool, Optimizer)]; first match wins,
    ``default`` otherwise.  E.g. row-wise Adagrad on ``.*table.*`` leaves
    (embedding tables), AMSGrad elsewhere — the paper's configuration.
    """
    return _Partitioned(init_leaf=None, update_leaf=None, rules=tuple(rules), default=default)

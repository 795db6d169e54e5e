"""The first training steps, plain: the model's forward, the mean BCE,
``torch.autograd.grad`` for every leaf, and the optimizer one leaf at a
time.  Leaves are ordered as the models lay them out: dict keys sorted,
lists in order."""

from __future__ import annotations

import dataclasses

import torch

from portbench.lib import tree as T

from . import loss as L
from .optim import RULES


@dataclasses.dataclass
class Steps:
    losses: list          # each step's loss
    grad_norms: list      # each leaf's first-gradient norm
    change: list          # each leaf's norm of the change over the steps


def steps(forward, conf, params, batches, opt: dict) -> Steps:
    """``len(batches)`` steps of the optimizer ``opt`` (the configuration's
    ``optimizer`` entry) from ``params``; the parameters are not changed."""
    init, rule = RULES[opt["kind"]]
    hyper = {k: v for k, v in opt.items() if k != "kind"}
    paths, p0 = zip(*T.items(params))
    cur = list(p0)
    state = [init(p) for p in cur]
    losses, grad_norms = [], None
    for t, batch in enumerate(batches, start=1):
        live = [p.detach().requires_grad_(True) for p in cur]
        with torch.enable_grad():
            logits = forward(T.rebuild(params, dict(zip(paths, live))), batch["dense"],
                             batch["sparse"], conf)
            loss = L.bce(logits, batch["label"])
            grads = torch.autograd.grad(loss, live)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            if grad_norms is None:
                grad_norms = [float(torch.linalg.vector_norm(g)) for g in grads]
            out = [rule(p, g, s, t, **hyper) for p, g, s in zip(cur, grads, state)]
        del live, grads, logits, loss
        cur, state = [o[0] for o in out], [o[1] for o in out]
    with torch.no_grad():
        change = [float(torch.linalg.vector_norm(a - b)) for a, b in zip(cur, p0)]
    return Steps(losses=losses, grad_norms=grad_norms, change=change)

"""AMSGrad (Reddi et al. 2019) and Adagrad (Duchi et al. 2011), plain, one
leaf at a time, f32 state.  ``t`` counts steps from 1."""

from __future__ import annotations

import torch


def amsgrad_init(p):
    return {"m": torch.zeros_like(p), "v": torch.zeros_like(p), "vmax": torch.zeros_like(p)}


def amsgrad(p, g, s, t: int, lr: float, b1: float = 0.9, b2: float = 0.999,
            eps: float = 1e-8):
    m = b1 * s["m"] + (1 - b1) * g
    v = b2 * s["v"] + (1 - b2) * g * g
    vmax = torch.maximum(s["vmax"], v)
    mhat = m / (1 - b1 ** t)
    vhat = vmax / (1 - b2 ** t)
    return p - lr * mhat / (torch.sqrt(vhat) + eps), {"m": m, "v": v, "vmax": vmax}


def adagrad_init(p):
    return {"acc": torch.zeros_like(p)}


def adagrad(p, g, s, t: int, lr: float, eps: float = 1e-10):
    acc = s["acc"] + g * g
    return p - lr * g / (torch.sqrt(acc) + eps), {"acc": acc}


RULES = {"amsgrad": (amsgrad_init, amsgrad), "adagrad": (adagrad_init, adagrad)}

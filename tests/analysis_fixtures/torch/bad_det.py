"""Seeded DET-001 violations, torch spelling: a wall-clock read and a draw
from the global generator inside bodies that torch.compile and
torch.jit.script trace — both freeze or vary outside the operands.  A
draw with an explicit generator= is allowed, as jax.random is."""

import time

import torch


def noisy(x, gen):
    keep = torch.rand(x.shape, generator=gen)          # allowed: explicit generator
    return x * keep + torch.randn(x.shape)             # DET-001


@torch.jit.script
def stamped(x):
    return x + time.time()                             # DET-001


compiled = torch.compile(noisy)

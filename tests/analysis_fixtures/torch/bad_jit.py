"""Seeded JIT-001 violations, torch spelling: a compiled wrapper built per
loop iteration and a compile-then-call in a single expression — both
discard the compile cache."""

import torch


def per_iteration(fns, x):
    outs = []
    for fn in fns:
        compiled = torch.compile(fn)                   # JIT-001: in loop
        outs.append(compiled(x))
    return outs


def per_call(fn, x):
    return torch.compile(fn)(x)                        # JIT-001: immediate

"""Seeded ACC-001 violations, torch spelling: a kernel file's plain
version reducing ref-derived data with no f32 upcast in the expression."""

import torch


def pool_plain(x_ref, mask_ref):
    w = mask_ref[..., None]
    return torch.sum(x_ref * w, dim=1)                 # ACC-001 here


def interact_plain(x_ref):
    return torch.bmm(x_ref, x_ref.transpose(1, 2))     # ACC-001 here


def pool_plain_ok(x_ref, mask_ref):
    w = mask_ref[..., None]
    a = torch.sum(x_ref * w, dim=1, dtype=torch.float32)
    b = (x_ref.float() * w).sum(dim=1)
    c = torch.bmm(x_ref.to(torch.float32), x_ref.to(torch.float32).transpose(1, 2))
    return a, b, c

"""TF32 switched on for a block: the control's precision, one step below
the f32 (TF32 off) that the configurations state."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def tf32():
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def state(conf) -> None:
    """The precision the configuration states, for the whole process."""
    torch.backends.cuda.matmul.allow_tf32 = conf["allow_tf32"]
    torch.backends.cudnn.allow_tf32 = conf["allow_tf32"]

"""The harness's ranges around the program's calls, opened in the traced
stretch only: ``wrapped`` replaces a module attribute by a wrapper that
opens a ``torch.profiler.record_function`` range; ``maybe`` opens one
around a block of the harness's own."""

from __future__ import annotations

import contextlib
import functools

import torch


@contextlib.contextmanager
def wrapped(module, attr: str, name: str):
    fn = getattr(module, attr)

    @functools.wraps(fn)
    def inner(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    setattr(module, attr, inner)
    try:
        yield
    finally:
        setattr(module, attr, fn)


def maybe(on: bool, name: str):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()

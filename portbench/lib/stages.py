"""Seconds of each stage of a set-up, on the host clock, each stage ended
by a synchronise so that its device work counts in it."""

from __future__ import annotations

import time

import torch


class Stages:
    def __init__(self):
        self.seconds: dict = {}
        self._t = time.perf_counter()

    def __call__(self, name: str) -> None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.seconds[name] = now - self._t
        self._t = now

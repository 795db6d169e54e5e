"""Device time of a call on the card, with CUDA events, and the card's
name and power limit to print beside it."""

from __future__ import annotations

import subprocess
import sys
import time
from typing import Optional

import torch

__all__ = ["device_ms", "card"]


def card() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them, or None on a machine
    without ``nvidia-smi``."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0]


def device_ms(fn, iters: int) -> float:
    """Device time of one ``fn()`` call: CUDA events around ``iters`` calls
    queued behind a sleep kernel long enough for the host to enqueue them
    all, so the host's launch cost stays off the device's clock.  When the
    host could not enqueue them within the sleep — the launch queue fills
    with calls of many kernels (plain versions, yardsticks, replaced
    routes) — it halves ``iters`` and measures again.  A call that waits on
    the device itself cannot be queued ahead at all: it is timed back to
    back, host included, and said so."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    per_call_s = (time.perf_counter() - t) / 5
    n = iters
    while True:
        ahead_s = max(0.1, 3 * n * per_call_s)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(ahead_s * 2e9))  # cycles: at most 2 GHz on an H100
        t = time.perf_counter()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        enqueued_s = time.perf_counter() - t
        torch.cuda.synchronize()
        if enqueued_s <= 0.9 * ahead_s:
            return start.elapsed_time(end) / n
        if n == 1:
            break
        n //= 2
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    print(f"  (timing: one call waits on the device, so {ms:.6f} ms is back-to-back "
          f"calls with the host's time included)", file=sys.stderr)
    return ms

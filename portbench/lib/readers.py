"""What the per-layer readers share.  A reader is ``read(ctx) -> float |
None``; it returns None where it finds nothing to read, and the harness
then leaves its metric out.  ``ctx`` holds the cell's ``conf``,
``traffic`` and ``model``, the card's ``peaks`` (None off the card), the
``window``'s record, the traced stretch's ``trace`` (None untraced) and
``traced`` record, and the driver's ``bench``."""

from __future__ import annotations

import statistics


def median_ms(ctx, key: str = "dispatch_s"):
    samples = ctx.window.get(key) or []
    return statistics.median(samples) * 1e3 if samples else None


def idle_share(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def mfu(ctx, passes: int):
    """The window's model FLOPs per second over the f32 peak, in %:
    ``passes`` forward passes' FLOPs per sample (3 for a training step)."""
    if ctx.peaks is None:
        return None
    rate = ctx.window["metrics"]["samples_per_s"]
    return 100.0 * passes * ctx.model.forward_flops(ctx.conf) * rate / ctx.peaks["f32_flops"]


def roofline(ctx, range_name: str, nbytes: int, flops: int):
    """The least time the stage could take (the larger of its bytes over
    HBM bandwidth and its FLOPs over the f32 peak) over the device time of
    every kernel under the harness's range, in %."""
    tr = ctx.trace
    spent = None if tr is None else tr.range_s.get(range_name)
    if ctx.peaks is None or not spent:
        return None
    least = max(nbytes / ctx.peaks["hbm_bytes_per_s"], flops / ctx.peaks["f32_flops"])
    return 100.0 * least / spent


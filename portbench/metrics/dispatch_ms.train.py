"""dispatch_ms.train: host ms a training step spends on its own work,
from the traced steps: the host time inside the harness's
``portbench.step`` range (the step's call to its return) less the part
its thread spent waiting for the device (``trace.range_wait_s``: a
synchronise, a copy, or a launch held while the device's queue is full),
per step.  The step as timed on the host clock alone reads the device's
time wherever the step waits for the card."""

NAME = "portbench.step"


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.range_calls.get(NAME):
        return None
    return (tr.range_host_s[NAME] - tr.range_wait_s[NAME]) / tr.range_calls[NAME] * 1e3

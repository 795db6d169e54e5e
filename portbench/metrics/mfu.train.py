"""mfu.train: the window's training FLOPs per second (three forward
passes' FLOPs per sample, ``lib/cost.py``, times samples per second) over
the card's f32 peak, in %."""

from portbench.lib import readers


def read(ctx):
    return readers.mfu(ctx, passes=3)

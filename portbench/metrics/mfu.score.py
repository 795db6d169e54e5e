"""mfu.score: the window's scoring FLOPs per second (the forward pass's
FLOPs per candidate, ``lib/cost.py``, times candidates per second) over
the card's f32 peak, in %."""

from portbench.lib import readers


def read(ctx):
    return readers.mfu(ctx, passes=1)

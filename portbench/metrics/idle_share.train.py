"""idle_share.train: the share of the traced steps in which no operation
ran on the device, in %."""

from portbench.lib import readers


def read(ctx):
    return readers.idle_share(ctx)

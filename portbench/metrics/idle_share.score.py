"""idle_share.score: the share of the traced stretch (one cycle of the
request pool) in which no operation ran on the device, in %."""

from portbench.lib import readers


def read(ctx):
    return readers.idle_share(ctx)

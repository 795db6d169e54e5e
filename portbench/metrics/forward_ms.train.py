"""forward_ms.train: device ms a step of every kernel launched inside the
program's ``repro.train.forward`` span (the loss, from the batch and the
parameters), on the span's thread, over the traced steps."""

from portbench.lib import spans

spans.install()     # this metric reads the program's spans in the traced stretch


def read(ctx):
    return spans.ms_per_step(ctx.trace, launched=[spans.FORWARD])

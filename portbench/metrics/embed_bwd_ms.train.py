"""embed_bwd_ms.train: device ms a step of every kernel launched by the
backward ops of the forward ops inside the program's ``repro.embed`` span
(the table gathers and their combine), on whatever thread autograd ran
them (``lib/spans.py``), over the traced steps."""

from portbench.lib import spans

spans.install()     # this metric reads the program's spans in the traced stretch


def read(ctx):
    return spans.ms_per_step(ctx.trace, backward=[spans.EMBED])

"""backward_ms.train: device ms a step of every kernel of the backward
pass, over the traced steps: those launched by the backward ops of the
forward ops inside ``repro.train.forward``, on whatever thread autograd
ran them, and those launched inside the program's ``repro.train.backward``
span on its own thread (``lib/spans.py``), each once."""

from portbench.lib import spans

spans.install()     # this metric reads the program's spans in the traced stretch


def read(ctx):
    return spans.ms_per_step(ctx.trace, launched=[spans.BACKWARD], backward=[spans.FORWARD])

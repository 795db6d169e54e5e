"""optimizer_ms.train: device ms per step of every kernel launched under
the harness's ``portbench.optimizer`` range, around the ``update`` of the
optimizer handed to ``make_train_step``."""

NAME = "portbench.optimizer"


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.range_s.get(NAME):
        return None
    return tr.range_s[NAME] / tr.range_calls[NAME] * 1e3

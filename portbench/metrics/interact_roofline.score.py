"""interact_roofline.score: DLRM's interaction's share of its roofline, in
%, over the traced requests: ``z`` and the features in, the top MLP's
input out (``lib/cost.py``), over the device time of every kernel under
the harness's ``portbench.interact`` range."""

from portbench.lib import cost, readers


def read(ctx):
    requests = ctx.traced.get("requests")
    if not requests:
        return None
    sizes = [ctx.bench.pool[k]["dense"].shape[0] for k in requests]
    return readers.roofline(ctx, "portbench.interact",
                            sum(cost.interact_bytes(ctx.conf, n) for n in sizes),
                            sum(cost.interact_flops(ctx.conf, n) for n in sizes))

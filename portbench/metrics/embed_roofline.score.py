"""embed_roofline.score: the one-hot embed stage's share of its roofline,
in %, over the traced requests.  Its bytes are each request's ids, each
distinct live (table, row) read once at its stored width with its scale
and zero point, and its ``(n, T, D)`` f32 output; its FLOPs five per
output element.  The time is the device time of every kernel under the
harness's ``portbench.embed`` range, so it reads the same work whatever
implements it."""

from portbench.lib import cost, readers

STORED = {"int8": "int8", "f32": "float32"}


def read(ctx):
    requests = ctx.traced.get("requests")
    if not requests:
        return None
    rows = ctx.model.remainder_rows(ctx.conf)
    stored = STORED[ctx.traffic["quantize"]]
    pool = ctx.bench.pool
    nbytes = sum(cost.embed_bytes(ctx.conf, pool[k]["sparse"], rows, stored) for k in requests)
    flops = sum(cost.embed_flops(ctx.conf, pool[k]["sparse"].shape[0]) for k in requests)
    return readers.roofline(ctx, "portbench.embed", nbytes, flops)

"""mlp_roofline.score: DLRM's MLPs' share of their roofline, in %, over the
traced requests: their least time, the larger of their FLOPs over the f32
peak and their bytes over HBM bandwidth (``lib/mlp_cost.py``), over the
device time of every kernel launched inside the program's ``repro.mlp``
spans on their thread."""

from portbench.lib import mlp_cost, spans

spans.install()     # this metric reads the program's spans in the traced stretch


def read(ctx):
    sp = spans.of(ctx.trace)
    requests = ctx.traced.get("requests")
    spent = sp and requests and sp.device_s(launched=[spans.MLP])
    if not spent or ctx.peaks is None:
        return None
    mlps = mlp_cost.dlrm_mlps(ctx.conf)
    sizes = [ctx.bench.pool[k]["dense"].shape[0] for k in requests]
    least = max(sum(mlp_cost.flops(mlps, n) for n in sizes) / ctx.peaks["f32_flops"],
                sum(mlp_cost.nbytes(mlps, n) for n in sizes) / ctx.peaks["hbm_bytes_per_s"])
    return 100.0 * least / spent

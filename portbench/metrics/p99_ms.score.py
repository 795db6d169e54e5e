"""p99_ms.score: the 99th percentile of the window's request latencies,
from the client's call to its scores in host memory, in ms, the wait
behind the requests in flight ahead of it included.  The closed loop runs
at capacity, where a tail swings with the host's hiccups from run to run;
it stands here without a bound."""


def read(ctx):
    return ctx.window["metrics"]["p99_ms"]

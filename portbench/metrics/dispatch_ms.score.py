"""dispatch_ms.score: host ms from the client's ``predict`` call to its
return (before the scores are read), the median over the window's
requests."""

from portbench.lib import readers


def read(ctx):
    return readers.median_ms(ctx)

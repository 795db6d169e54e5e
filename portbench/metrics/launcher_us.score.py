"""launcher_us.score: host µs a kernel launch takes in the port's
launchers (the program's ``repro.launch`` spans: K5's grouped lookup and
K2's interaction; checks, operand packing and the C call), less the part
its thread spent waiting for the device, the mean over the traced
stretch's launches."""

from portbench.lib import spans

spans.install()     # this metric reads the program's spans in the traced stretch


def read(ctx):
    sp = spans.of(ctx.trace)
    calls = sp and sp.calls.get(spans.LAUNCH)
    if not calls:
        return None
    return (sp.host_s[spans.LAUNCH] - sp.wait_s[spans.LAUNCH]) / calls * 1e6

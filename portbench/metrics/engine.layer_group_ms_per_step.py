"""Scheduler and engine: the host time of the port's encoder step per
fused step spent issuing its depth groups, in ms: the self time of the
``engine.layer_group`` spans (one per group: the gathers, the layer's and
its off-ramp's launches, the scatters) over the steps inside the window's
host part.  The program's spans (``ctx["program"]``); None without them
or where no group span ran."""
from portbench import program


def read(ctx):
    recs = program.records(ctx)
    if recs is None:
        return None
    n, t, names = program.steps(recs, *program.host_window(ctx))
    if n == 0 or names["engine.layer_group"] == 0:
        return None
    return t["engine.layer_group"] / n / 1e6

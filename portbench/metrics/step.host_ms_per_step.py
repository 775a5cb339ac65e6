"""Model step: the host time of the port's fused step per step, in ms:
the self time of its ``engine.lanes_step`` spans (the input copies and the
launches' issue; the arbiter's ``dvfs.arbitrate`` and the outputs'
``step.readback`` are spans of their own), over the steps inside the
window's host part.  The program's spans (``ctx["program"]``); None
without them."""
from portbench import program


def read(ctx):
    recs = program.records(ctx)
    if recs is None:
        return None
    n, t, _ = program.steps(recs, *program.host_window(ctx))
    if n == 0:
        return None
    return t["engine.lanes_step"] / n / 1e6

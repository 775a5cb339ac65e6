"""Scheduler and engine: the host time of the port's scheduler per fused
step, in ms: the self time of its ``sched.step`` spans and of the
``sched.*`` spans inside them (choosing the bucket, the refill loop, the
retire loop), over the steps inside the window's host part.  The
program's spans (``ctx["program"]``); None without them."""
from portbench import program


def read(ctx):
    recs = program.records(ctx)
    if recs is None:
        return None
    n, t, _ = program.steps(recs, *program.host_window(ctx))
    if n == 0:
        return None
    return sum(v for k, v in t.items() if k.startswith("sched.")) / n / 1e6

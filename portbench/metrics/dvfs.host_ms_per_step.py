"""DVFS arbiter: the host time of the port's modeled DVFS arbiter per
fused step, in ms: every ``dvfs.*`` span (admitting a loaded lane, the
step's arbitration, a lane's first entropy and its retirement) over the
steps inside the window's host part.  The program's spans
(``ctx["program"]``); None without them."""
from portbench import program


def read(ctx):
    recs = program.records(ctx)
    if recs is None:
        return None
    n, t, _ = program.steps(recs, *program.host_window(ctx))
    if n == 0:
        return None
    return sum(v for k, v in t.items() if k.startswith("dvfs.")) / n / 1e6

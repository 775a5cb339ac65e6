"""Scheduler and engine (the refill): the host time of one lane load, in
us: the self time of the port's ``engine.lane_load`` spans (the token
row's copy to the card, the embedding's launches, the lane insert) over
their number, in the fused steps inside the window's host part.  The
program's spans (``ctx["program"]``); None without them."""
from portbench import program


def read(ctx):
    recs = program.records(ctx)
    if recs is None:
        return None
    _, t, n = program.steps(recs, *program.host_window(ctx))
    if n["engine.lane_load"] == 0:
        return None
    return t["engine.lane_load"] / n["engine.lane_load"] / 1e3

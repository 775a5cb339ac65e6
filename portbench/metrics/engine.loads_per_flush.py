"""Scheduler and engine (the refill): the lanes loaded per flush, the
lane loads the port's classifier staged over the flushes that embedded
them before a fused step (``telemetry()``'s ``lane_loads`` over
``load_flushes``, their change over the window's host part); None where
the telemetry has no ``load_flushes``."""


def read(ctx):
    t0, t1 = ctx["w"]["tel0"], ctx["w"]["tel1"]
    if "load_flushes" not in t1:
        return None
    flushes = t1["load_flushes"] - t0["load_flushes"]
    if flushes <= 0:
        return None
    return (t1["lane_loads"] - t0["lane_loads"]) / flushes

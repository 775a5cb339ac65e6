"""Scheduler: the share of lane slots that held a sentence over the
window's fused steps (``telemetry()``'s ``layer_calls`` and
``dense_steps``, their change over the window), in %."""


def read(ctx):
    t0, t1 = ctx["w"]["tel0"], ctx["w"]["tel1"]
    steps = t1["dense_steps"] - t0["dense_steps"]
    if steps <= 0:
        return None
    return 100.0 * (t1["layer_calls"] - t0["layer_calls"]) / (steps * ctx["lanes"])

"""Scheduler and engine: the depth groups the port's classifier ran per
fused step (one layer call for the lanes at one depth: 1 where every lane
runs the one shared layer), ``telemetry()``'s ``depth_groups`` over
``dense_steps``, their change over the window's host part; None where the
telemetry has no ``depth_groups``."""


def read(ctx):
    t0, t1 = ctx["w"]["tel0"], ctx["w"]["tel1"]
    if "depth_groups" not in t1:
        return None
    steps = t1["dense_steps"] - t0["dense_steps"]
    if steps <= 0:
        return None
    return (t1["depth_groups"] - t0["depth_groups"]) / steps

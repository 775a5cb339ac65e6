"""Device: the blocking copies between the host and the card that the
port's serving path issued per fused step (``telemetry()``'s
``host_syncs`` over ``dense_steps``, their change over the window's host
part); None where the telemetry has no ``host_syncs``."""


def read(ctx):
    t0, t1 = ctx["w"]["tel0"], ctx["w"]["tel1"]
    if "host_syncs" not in t1:
        return None
    steps = t1["dense_steps"] - t0["dense_steps"]
    if steps <= 0:
        return None
    return (t1["host_syncs"] - t0["host_syncs"]) / steps

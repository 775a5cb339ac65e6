"""Early exit: the mean exit layer of the sentences retired in the window
(``telemetry()``'s ``avg_exit_layer`` and ``sentences``, their change over
the window)."""


def read(ctx):
    t0, t1 = ctx["w"]["tel0"], ctx["w"]["tel1"]
    n = t1["sentences"] - t0["sentences"]
    if n <= 0:
        return None
    return (t1["avg_exit_layer"] * t1["sentences"] - t0["avg_exit_layer"] * t0["sentences"]) / n

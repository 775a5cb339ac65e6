"""Scheduler: the 95th percentile over the window's sentences of the time
from each one's due time to the start of the fused step that first
computed it (the step numbered ``Request.first_compute_step``), in ms."""
from portbench.stats import percentile


def read(ctx):
    w = ctx["w"]
    base = w["steps_before"]
    walls = w["step_walls"]
    waits = []
    for r in w["recs"]:
        if not w["t0"] <= r.due <= w["h_end"]:
            continue
        idx = getattr(r.req, "first_compute_step", None) if r.req is not None else None
        if idx is not None and 0 <= idx - base < len(walls):
            waits.append((walls[idx - base] - r.due) * 1e3)
    return percentile(waits, 95) if waits else None

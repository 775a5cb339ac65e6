"""Model step: over the fused decode steps inside the traced window, the
sum of each step's least time (the bytes it needs at the HBM rate, or its
operations at the bf16 peak: ``work.dense_step_bytes`` and
``work.dense_token_flops``) over the device time inside those steps, in
%."""
from portbench import peaks, tracing, work


def read(ctx):
    t, hooks = ctx["trace"], ctx["hooks"]
    if t is None or hooks is None or ctx["cfg"]["family"] != "dense":
        return None
    m = ctx["cfg"]["model"]
    lo, hi = t["lo_ns"], t["hi_ns"]
    steps = [s for s in hooks.steps if lo <= s["t0"] and s["t1"] <= hi and "positions" in s]
    least = sum(peaks.roofline_s(sum(work.dense_token_flops(m, p + 1, s["max_exit"]) for p in s["positions"]),
                                 work.dense_step_bytes(m, s["positions"], s["max_exit"]))
                for s in steps)
    dev = tracing.busy_inside(t["busy"], [(s["t0"], s["t1"]) for s in steps])
    return 100.0 * least / dev if dev > 0 and least > 0 else None

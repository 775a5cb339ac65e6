"""Kernels: the span-attention kernel's calls in the fused steps inside
the traced window, the sum of each call's least time (its operations at
the bf16 peak or its bytes at the HBM rate, whichever is larger:
``encoder_work.span_call``, from the bucket, the lane's valid length and
the kind of attention of the layer the lane ran) over the device time of
those calls, in %.  Which layer each lane ran comes from the port's layer
log (``ClassifierServer.layer_log``, handed over by the family under
``ctx["cal"]["layer_log"]``), matched to a step by the time it came back; None
where there is no log."""
import bisect

from portbench import encoder_work, peaks

SYMBOL = "span_attention_kernel"


def read(ctx):
    t, hooks = ctx["trace"], ctx["hooks"]
    log = (ctx.get("cal") or {}).get("layer_log")
    if t is None or hooks is None or not log:
        return None
    m = ctx["cfg"]["model"]
    times = [e[0] for e in log]
    least, steps = 0.0, []
    for s in hooks.steps:
        if not (t["lo_ns"] <= s["t0"] and s["t1"] <= t["hi_ns"]):
            continue
        i = bisect.bisect_left(times, s["t0"])
        if i == len(times) or times[i] > s["t1"]:
            continue
        for lane, layer in enumerate(log[i][1].tolist()):
            if layer >= 0:
                least += peaks.roofline_s(*encoder_work.span_call(m, layer, s["bucket"], s["lane_len"][lane]))
        steps.append((s["t0"], s["t1"]))
    starts = [a for a, _ in steps]
    dev = 0.0
    for a, b, name in t["ops"]:
        j = bisect.bisect_right(starts, (a + b) // 2) - 1
        if SYMBOL in name and j >= 0 and (a + b) // 2 <= steps[j][1]:
            dev += (b - a) / 1e9
    return 100.0 * least / dev if dev > 0 and least > 0 else None

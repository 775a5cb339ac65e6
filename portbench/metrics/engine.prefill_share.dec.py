"""Engine: the share of the window's wall time spent inside ``lane_load``
(the decoder's one-token prefill, synchronised at its end in the traced
run), in %."""


def read(ctx):
    w = ctx["w"]
    lo, hi = int(w["t0"] * 1e9), int(w["h_end"] * 1e9)
    if not ctx["spans"].inner:
        return None
    return 100.0 * ctx["spans"].total_s("lane_load", lo, hi) / w["h_seconds"]

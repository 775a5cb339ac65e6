"""Model step: the model FLOPs the window's work needed over what the
card's bf16 peak gives in the window, in % (``families.<family>``'s
``window_flops``: counted from the configuration's shapes and each
request's sizes, never from what was launched)."""
from portbench.peaks import BF16_FLOP_PER_S


def read(ctx):
    flops = ctx["fam"].window_flops(ctx)
    if not flops:
        return None
    return 100.0 * flops / (ctx["w"]["h_seconds"] * BF16_FLOP_PER_S)

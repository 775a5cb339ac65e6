"""Load generator: the 99th percentile over the window's open-loop
submissions of how late each ran behind its due time (ms)."""
from portbench.stats import percentile


def read(ctx):
    w = ctx["w"]
    lags = [(r.submit - r.due) * 1e3 for r in w["recs"] if r.submit is not None and w["t0"] <= r.due <= w["h_end"]]
    return percentile(lags, 99) if lags else None

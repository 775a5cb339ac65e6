"""The traced run's instruments: host spans kept in memory, and a window of
the device trace (``torch.profiler``, CUDA activity only) reduced to busy
time, time by device operation, and idle time by the host span open then.

Host spans are ``time.perf_counter_ns`` readings.  The profiler stamps
device operations in ns since the epoch (``time.time_ns``'s clock): the
two host clocks read together at the window's start tie them."""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import numpy as np



class Spans:
    """Named host intervals.  ``outer`` spans (the load generator's phases) do not
    overlap each other; ``inner`` spans (the server's hooks) lie inside
    one outer span."""

    def __init__(self, on: bool):
        self.on = on
        self.outer: List[Tuple[int, int, str]] = []
        self.inner: List[Tuple[int, int, str]] = []

    @contextmanager
    def span(self, name: str, inner: bool = False):
        if not self.on:
            yield
            return
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            (self.inner if inner else self.outer).append((t0, time.perf_counter_ns(), name))

    def total_s(self, name: str, lo_ns: int, hi_ns: int) -> float:
        """Seconds of the spans called ``name`` inside [lo, hi]."""
        tot = 0
        for a, b, n in self.inner + self.outer:
            if n == name:
                tot += max(0, min(b, hi_ns) - max(a, lo_ns))
        return tot / 1e9

    def segments(self) -> List[Tuple[int, int, str]]:
        """The host timeline as disjoint labelled pieces, sorted: each outer
        span with the inner spans inside it cut out and labelled by their
        own names."""
        inner = sorted(self.inner)
        out, j = [], 0
        for a, b, name in sorted(self.outer):
            cur = a
            while j < len(inner) and inner[j][0] < b:
                ia, ib, iname = inner[j]
                if ia > cur:
                    out.append((cur, ia, name))
                out.append((max(ia, a), min(ib, b), iname))
                cur = max(cur, ib)
                j += 1
            if cur < b:
                out.append((cur, b, name))
        return out


class DeviceWindow:
    """``torch.profiler`` over [start(), stop()], reduced by ``summary``."""

    def __init__(self):
        self.prof = None
        self.host0 = self.host1 = None
        self.epoch_minus_host = None

    @staticmethod
    def init() -> None:
        """One short profiler run: the profiler's one-time start-up (it
        takes seconds) happens here, before the window, not in it."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.host0 = time.perf_counter_ns()
        self.epoch_minus_host = time.time_ns() - self.host0

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.host1 = time.perf_counter_ns()
        self.prof.__exit__(None, None, None)

    def events(self) -> List[Tuple[int, int, str]]:
        """(start ns, end ns, name) of every device operation, device clock."""
        import torch

        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
            dur = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
            out.append((int(start), int(start + dur), e.name()))
        return out


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def summary(win: DeviceWindow, spans: Spans, top: int = 10) -> Optional[Dict]:
    """The window's device time: ``busy_s`` (the union of every device
    operation inside the window), ``window_s``, the operations that took
    most time, the idle time split by the host span open during it (the
    innermost), and ``ops`` (start, end, name) on the host clock for readers
    that attribute device time to host spans.  None when the trace holds
    no device operation inside the window."""
    evs = win.events()
    offset = win.epoch_minus_host
    lo, hi = win.host0, win.host1
    win.note = {"device_events": len(evs), "window_ns": hi - lo,
                "first_ns": min((e[0] - offset - lo for e in evs), default=None),
                "last_ns": max((e[1] - offset - lo for e in evs), default=None)}
    ops = [(a - offset, b - offset, n) for a, b, n in evs]
    ops = [(max(a, lo), min(b, hi), n) for a, b, n in ops if b > lo and a < hi]
    if not ops:
        return None
    busy = _union([(a, b) for a, b, _ in ops])
    by_name: Dict[str, float] = {}
    for a, b, n in ops:
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e9
    gaps: Dict[str, float] = {}
    edges = [(lo, lo)] + busy + [(hi, hi)]
    segs = spans.segments()
    j = 0
    for (_, g0), (g1, _) in zip(edges, edges[1:]):
        if g1 <= g0:
            continue
        covered = 0
        while j < len(segs) and segs[j][1] <= g0:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < g1:
            a, b, name = segs[k]
            ov = min(b, g1) - max(a, g0)
            if ov > 0:
                gaps[name] = gaps.get(name, 0.0) + ov / 1e9
                covered += ov
            k += 1
        if g1 - g0 > covered:
            gaps["outside any span"] = gaps.get("outside any span", 0.0) + (g1 - g0 - covered) / 1e9
    busy_s = sum(b - a for a, b in busy) / 1e9
    return {
        "busy_s": busy_s,
        "window_s": (hi - lo) / 1e9,
        "lo_ns": lo, "hi_ns": hi,
        "busy": busy,
        "ops": ops,
        "device_ops": [[n[:160], s] for n, s in sorted(by_name.items(), key=lambda x: -x[1])[:top]],
        "idle_gaps": [[n, s] for n, s in sorted(gaps.items(), key=lambda x: -x[1])[:top]],
    }


def busy_inside(busy: List[Tuple[int, int]], spans: List[Tuple[int, int]]) -> float:
    """Seconds of the busy intervals that fall inside ``spans`` (host ns)."""
    if not busy or not spans:
        return 0.0
    b = np.asarray(busy, dtype=np.int64)
    tot = 0
    for a, z in spans:
        lo, hi = np.maximum(b[:, 0], a), np.minimum(b[:, 1], z)
        tot += int(np.clip(hi - lo, 0, None).sum())
    return tot / 1e9

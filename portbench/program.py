"""The port's own host spans in a traced run, as the readers use them.

The port records spans inside its serving loop when its recorder
(``repro_torch.serving.trace``) is enabled: ``sched.step`` around each
fused step, with ``sched.choose``, ``sched.refill`` (``engine.lane_load``,
``dvfs.admit``), ``engine.lanes_step`` (``dvfs.arbitrate``,
``step.readback``) and ``sched.retire`` (``dvfs.retire``) inside it.  A
record is ``(start_ns, end_ns, name, parent, uid)`` on the host's
``time.perf_counter_ns`` clock, the clock of the benchmark's own spans,
``parent`` the index of the enclosing record (-1 at the top) and ``end_ns``
-1 while the span is open.

A reader finds the recorder under ``ctx["program"]``; where there is none
(a run that did not enable it, or a program without it) it reads nothing
and returns None.
"""
from __future__ import annotations

import bisect
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from portbench.tracing import Spans, _union

OUTSIDE = "outside any span"


def records(ctx) -> Optional[list]:
    """The program's records, or None where the run has no recorder."""
    rec = ctx.get("program")
    return None if rec is None else rec.records()


def children(recs: Sequence) -> Dict[int, List[int]]:
    """Each record's children in the order they began (key -1: the tops)."""
    out: Dict[int, List[int]] = {}
    for j, r in enumerate(recs):
        out.setdefault(r[3], []).append(j)
    return out


def self_ns(recs: Sequence, kids: Dict[int, List[int]]) -> List[int]:
    """Each closed record's time in none of its children (0 for one still
    open)."""
    out = []
    for j, r in enumerate(recs):
        if r[1] < 0:
            out.append(0)
            continue
        out.append(r[1] - r[0] - sum(recs[c][1] - recs[c][0] for c in kids.get(j, ()) if recs[c][1] >= 0))
    return out


def steps(recs: Sequence, lo_ns: int, hi_ns: int) -> Tuple[int, Counter, Counter]:
    """Over the ``sched.step`` spans inside [lo, hi]: their number, and the
    self time (ns) and count of every span name within them."""
    kids = children(recs)
    own = self_ns(recs, kids)
    t, n = Counter(), Counter()
    tops = [j for j, r in enumerate(recs)
            if r[2] == "sched.step" and r[1] >= 0 and lo_ns <= r[0] and r[1] <= hi_ns]
    todo = list(tops)
    while todo:
        j = todo.pop()
        t[recs[j][2]] += own[j]
        n[recs[j][2]] += 1
        todo += kids.get(j, ())
    return len(tops), t, n


def host_window(ctx) -> Tuple[int, int]:
    """The window's host part, [t0, h_end], in ns."""
    w = ctx["w"]
    return int(w["t0"] * 1e9), int(w["h_end"] * 1e9)


def segments(recs: Sequence) -> List[Tuple[int, int, str]]:
    """The program's host timeline as disjoint labelled pieces, sorted: each
    closed span's self time under its own name."""
    kids = children(recs)
    out = []
    for j, r in enumerate(recs):
        if r[1] < 0:
            continue
        cur = r[0]
        for c in kids.get(j, ()):
            a, b = recs[c][0], recs[c][1]
            if b < 0:
                continue
            if a > cur:
                out.append((cur, a, r[2]))
            cur = max(cur, b)
        if cur < r[1]:
            out.append((cur, r[1], r[2]))
    return sorted(out)


def _minus(segs: List[Tuple[int, int, str]], cover: List[Tuple[int, int]]) -> List[Tuple[int, int, str]]:
    """``segs`` (sorted, disjoint) less the sorted disjoint ``cover``."""
    out, j = [], 0
    for a, b, name in segs:
        while j < len(cover) and cover[j][1] <= a:
            j += 1
        cur, k = a, j
        while k < len(cover) and cover[k][0] < b:
            if cover[k][0] > cur:
                out.append((cur, cover[k][0], name))
            cur = max(cur, cover[k][1])
            k += 1
        if cur < b:
            out.append((cur, b, name))
    return out


def idle_gaps(trace_sum: Dict, recs: Sequence, spans: Spans, top: int = 10) -> List[List]:
    """The traced window's device idle time (seconds) by the innermost
    program span open then; idle in no program span goes under the
    benchmark's span open then (``Spans.segments``), and idle in neither
    under ``outside any span``."""
    prog = segments(recs)
    labelled = sorted(prog + _minus(spans.segments(), _union([(a, b) for a, b, _ in prog])))
    lo, hi = trace_sum["lo_ns"], trace_sum["hi_ns"]
    edges = [(lo, lo)] + list(trace_sum["busy"]) + [(hi, hi)]
    gaps: Dict[str, float] = {}
    j = 0
    for (_, g0), (g1, _) in zip(edges, edges[1:]):
        if g1 <= g0:
            continue
        covered = 0
        while j < len(labelled) and labelled[j][1] <= g0:
            j += 1
        k = j
        while k < len(labelled) and labelled[k][0] < g1:
            a, b, name = labelled[k]
            ov = min(b, g1) - max(a, g0)
            if ov > 0:
                gaps[name] = gaps.get(name, 0.0) + ov / 1e9
                covered += ov
            k += 1
        if g1 - g0 > covered:
            gaps[OUTSIDE] = gaps.get(OUTSIDE, 0.0) + (g1 - g0 - covered) / 1e9
    return [[n, s] for n, s in sorted(gaps.items(), key=lambda x: -x[1])[:top]]


def readback_skew(trace_sum: Dict, recs: Sequence, copy: str = "DtoH") -> Optional[Dict]:
    """The clock check of the traced window: for each ``step.readback`` span
    inside it, the device-to-host copy (an operation whose name holds
    ``copy``) whose end lies nearest the span, and how far that end falls
    outside the span (0 inside it).  Since the host waits for the copy
    inside the span, a tie of the two clocks that holds puts every end
    inside.  Besides the share inside and the worst distance, the copy's
    end less the span's end (at most 0 where the tie holds) at the
    window's first and last steps and its least-squares drift per second.
    None where the window holds no such span or copy."""
    lo, hi = trace_sum["lo_ns"], trace_sum["hi_ns"]
    ends = sorted(b for _, b, n in trace_sum["ops"] if copy in n)
    spans = [(r[0], r[1]) for r in recs if r[2] == "step.readback" and r[1] >= 0 and lo <= r[0] and r[1] <= hi]
    if not ends or not spans:
        return None
    skews, late = [], []
    for a, b in spans:
        i = bisect.bisect_left(ends, a)
        e = min(ends[max(i - 1, 0):i + 2], key=lambda e: 0 if a <= e <= b else min(abs(a - e), abs(e - b)))
        skews.append(0 if a <= e <= b else min(abs(a - e), abs(e - b)))
        late.append(e - b)
    t = np.array([b for _, b in spans], dtype=np.float64) / 1e9
    drift = float(np.polyfit(t - t[0], np.array(late) / 1e3, 1)[0]) if len(spans) > 1 else 0.0
    return {"steps": len(spans), "copies": len(ends), "inside": sum(1 for s in skews if s == 0) / len(spans),
            "worst_us": max(skews) / 1e3, "end_gap_first_us": late[0] / 1e3, "end_gap_last_us": late[-1] / 1e3,
            "drift_us_per_s": drift}

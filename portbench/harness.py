"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

The window drives the port's serving entry as its launcher does
(``submit`` / ``step`` / ``poll``) from one host thread: an open loop sends
each request when it is due, a closed loop sends a client's next request
when its last one is polled.  Every time is the host's
``time.perf_counter``."""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from portbench import spec as spec_mod
from portbench import stats, tracing
from portbench.gen import make as make_traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# how long after the window's close the check waits for a sampled answer
LATE_S = 60.0
# the traced run profiles the device over the last TRACE_S seconds of the
# window (at most half of it); its host-side numbers come from the rest
TRACE_S = 3.0


@dataclass
class Rec:
    """One request of the window, from the load generator's side."""
    uid: int
    spec: Dict
    due: float
    submit: Optional[float] = None
    req: Any = None
    done_t: Optional[float] = None
    out: Optional[Dict] = None
    ntok: int = 0
    tok_t: List[float] = field(default_factory=list)


def host_probe_ms() -> float:
    """Milliseconds of a fixed pure-Python loop: how fast this run's host
    thread is, beside the numbers it times."""
    t = time.perf_counter()
    x = 0
    for i in range(300_000):
        x += i
    return (time.perf_counter() - t) * 1e3


def card_state() -> str:
    """The card's SM clock, power draw, temperature and active throttle
    reasons (``nvidia-smi``), or why they could not be read."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu,"
                              "clocks_throttle_reasons.active", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()[:200]
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read: {e}"


def family(cfg: Dict):
    return importlib.import_module(f"portbench.families.{cfg['family']}")


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is that of JAX,
    Flax or the JAX package, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Hooks:
    """The traced run's wrappers on the server instance's hooks: spans
    around ``lane_load`` (for a decoder, synchronised after: its prefill
    runs there) and ``lanes_step``, and the shapes of each fused step (the
    bucket, every lane's valid length, the active lanes and, for a
    decoder, each active lane's position and the deepest exit)."""

    def __init__(self, server, spans: tracing.Spans, decoder: bool):
        import torch

        self.steps: List[Dict] = []
        self.lane_len: Dict[int, List[int]] = {}
        self.lane_req: Dict[int, List[Any]] = {}
        load, step, begin = server.lane_load, server.lanes_step, server.bucket_begin
        lanes = server.lanes

        def bucket_begin(bucket):
            self.lane_len[bucket] = [bucket] * lanes
            self.lane_req[bucket] = [None] * lanes
            return begin(bucket)

        def lane_load(bucket, lane, req):
            with spans.span("lane_load", inner=True):
                load(bucket, lane, req)
                if decoder:
                    torch.cuda.synchronize()
            self.lane_len[bucket][lane] = len(req.tokens)
            self.lane_req[bucket][lane] = req

        def lanes_step(bucket, active):
            t0 = time.perf_counter_ns()
            with spans.span("lanes_step", inner=True):
                out = step(bucket, active)
            act = np.flatnonzero(active)
            reqs = self.lane_req[bucket]
            rec = {"t0": t0, "t1": time.perf_counter_ns(), "bucket": bucket, "n_active": len(act),
                   "lane_len": list(self.lane_len[bucket])}
            if decoder:
                # the step's outputs: (tokens, exit layers, first entropies, logits)
                rec["max_exit"] = int(out[1][act].max()) if len(act) else 0
                rec["positions"] = [len(reqs[i].tokens) - 1 + len(reqs[i].generated) for i in act]
            self.steps.append(rec)
            return out

        server.bucket_begin, server.lane_load, server.lanes_step = bucket_begin, lane_load, lanes_step


def run_window(server, fam, traffic, seconds: float, spans: tracing.Spans, trace: bool):
    """Drive the server for ``seconds`` after the traffic's ramp; returns the
    window's records and stamps.  With ``trace`` the device is profiled
    over the window's last TRACE_S seconds, and the host-side numbers are
    read over the part before (``h_end``, ``tel1``).  Python's cyclic
    garbage collector is off over the ramp and the window, with what set-up
    made frozen out of its reach: no collection pauses the host thread in
    the window (reference counting still frees what the window drops)."""
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        return _drive(server, fam, traffic, seconds, spans, trace)
    finally:
        gc.enable()
        gc.unfreeze()


def _drive(server, fam, traffic, seconds: float, spans: tracing.Spans, trace: bool):
    clock = time.perf_counter
    recs: List[Rec] = []
    inflight: Dict[int, Rec] = {}
    state = {"uid": 0}

    def new(due):
        with spans.span("generator"):
            spec = traffic.next_request()
        rec = Rec(uid=state["uid"], spec=spec, due=due)
        state["uid"] += 1
        recs.append(rec)
        return rec

    def send(rec):
        with spans.span("submit"):
            rec.req = fam.request(rec.uid, rec.spec)
            rec.submit = clock()
            server.submit(rec.req)
        inflight[rec.uid] = rec

    win = tracing.DeviceWindow() if trace else None
    if win is not None:
        win.init()
    tel0 = tel1 = None
    step_walls: List[float] = []
    base = server.sched.telemetry()["dense_steps"]
    t_r = clock()                          # serving starts; the window opens after the ramp
    t0 = t_r + traffic.ramp_s
    t_end = t0 + seconds
    h_end = t_end - min(TRACE_S, seconds / 2) if win is not None else t_end
    next_due = t_r + traffic.next_gap_s() if traffic.open_loop else None
    if not traffic.open_loop:
        for _ in range(traffic.clients):
            send(new(t_r))
    while True:
        now = clock()
        if now >= t_end:
            break
        if tel0 is None and now >= t0:
            tel0 = server.telemetry()
        if tel1 is None and now >= h_end:
            tel1 = server.telemetry()
            if win is not None:
                win.start()
        if next_due is not None:
            while next_due <= now:
                send(new(next_due))
                next_due += traffic.next_gap_s()
        if not inflight:
            with spans.span("wait for an arrival"):
                time.sleep(max(0.0, min(next_due, t_end) - clock()))
            continue
        with spans.span("step"):
            w = clock()
            rep = server.step()
        if rep is not None:
            step_walls.append(w)
        t = clock()
        if fam.streams_tokens:
            for rec in inflight.values():
                n = len(rec.req.generated)
                if n > rec.ntok:
                    rec.tok_t.extend([t] * (n - rec.ntok))
                    rec.ntok = n
        with spans.span("poll"):
            finished = server.poll()
        for req in finished:
            rec = inflight.pop(req.uid)
            rec.done_t, rec.out = t, fam.outcome(req)
        if not traffic.open_loop:
            for _ in finished:
                send(new(t))
    if win is not None and win.host0 is not None:
        win.stop()
    tel1 = tel1 or server.telemetry()
    return {"recs": recs, "inflight": inflight, "t0": t0, "t_end": t_end, "seconds": seconds,
            "h_end": h_end, "h_seconds": h_end - t0,
            "step_walls": step_walls, "steps_before": base, "tel0": tel0 or tel1, "tel1": tel1, "win": win}


def finish_late(server, fam, w: Dict, wanted: List[Rec]) -> None:
    """Step the server on after the window until every record in
    ``wanted`` has its answer (at most LATE_S): late is late, not wrong."""
    t_stop = time.perf_counter() + LATE_S
    missing = {r.uid for r in wanted if r.out is None}
    while missing and time.perf_counter() < t_stop:
        if server.step() is None:
            break
        for req in server.poll():
            rec = w["inflight"].pop(req.uid, None)
            if rec is not None:
                rec.done_t, rec.out = time.perf_counter(), fam.outcome(req)
                missing.discard(rec.uid)


def in_window(w: Dict) -> List[Rec]:
    """The requests due inside the window."""
    return [r for r in w["recs"] if w["t0"] <= r.due <= w["t_end"]]


def end_to_end(cell, fam, w: Dict) -> Dict[str, float]:
    """The cell's end-to-end numbers from the window's stamps (see
    ``BENCHMARK.json``): every sentence due in the window counts in the
    tail, one still in flight at the close with its age then."""
    t0, t_end, secs = w["t0"], w["t_end"], w["seconds"]
    due = in_window(w)
    out = {}
    lat = [((r.done_t if r.done_t is not None and r.done_t <= t_end else t_end) - r.due) * 1e3 for r in due]
    out["cls_p95_ms"] = stats.percentile(lat, 95)
    out["cls_sentences_per_s"] = sum(1 for r in w["recs"] if r.done_t is not None and t0 <= r.done_t <= t_end) / secs
    toks = [t for r in w["recs"] for t in r.tok_t if t0 <= t <= t_end]
    out["dec_tokens_per_s"] = len(toks) / secs
    gaps = [(b - a) * 1e3 for r in w["recs"] for a, b in zip(r.tok_t, r.tok_t[1:]) if t0 <= b <= t_end]
    out["dec_p95_gap_ms"] = stats.percentile(gaps, 95)
    return out


def load_reader(name: str):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, or,
    where there is none, the file of the name without its last dotted
    suffix, and so on (``step.mfu.tput`` falls back to ``step.mfu``: the
    suffix only says which end-to-end metric the number moves)."""
    folder = Path(__file__).resolve().parent / "metrics"
    stem = name
    while not (folder / f"{stem}.py").exists() and "." in stem:
        stem = stem.rsplit(".", 1)[0]
    path = folder / f"{stem}.py"
    sp = importlib.util.spec_from_file_location(f"portbench_metric_{stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def run_cell(cell: spec_mod.Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None, control: bool = False) -> Dict:
    """One run of ``cell``: returns the result line's object, with the
    compared numbers under ``checks`` (its last key)."""
    import torch

    from portbench.reference import set_tf32

    t_start = time.perf_counter() if t_start is None else t_start
    cfg, fam = cell.config, family(cell.config)
    cuda = torch.device(device).type == "cuda"
    set_tf32(False)
    params = fam.make_weights(cfg, seed, device)
    cal = fam.calibrate(cfg, params, seed, device, cell.traffic)
    server = fam.build_server(cfg, params, cal, device)
    traffic = make_traffic(cell.traffic, seed, fam.vocab(cfg))
    fam.warmup(cfg, server, traffic)
    spans = tracing.Spans(on=trace)
    trace = trace and cuda
    hooks = Hooks(server, spans, decoder=fam.streams_tokens) if trace else None
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    env = {"host_probe_ms_before": host_probe_ms(), "card_before": card_state() if cuda else None}
    w = run_window(server, fam, traffic, seconds, spans, trace)
    env.update(host_probe_ms_after=host_probe_ms(), card_after=card_state() if cuda else None)
    setup_s = w["t0"] - t_start
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    for r in w["recs"]:
        if r.out is None and r.req is not None and fam.done(r.req):
            r.out = fam.outcome(r.req)
    attempted = len(in_window(w))
    failed = sum(1 for r in w["recs"] if r.req is not None and getattr(r.req, "shed", False))

    metrics: Dict[str, Dict] = {}
    trace_sum = None
    if trace:
        trace_sum = tracing.summary(w["win"], spans) if w["win"] is not None and w["win"].host1 else None
        ctx = {"cell": cell, "cfg": cfg, "fam": fam, "w": w, "hooks": hooks, "spans": spans,
               "trace": trace_sum, "lanes": server.lanes, "cal": cal}
        for m in cell.per_layer:
            v = load_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = end_to_end(cell, fam, w)
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        for m in cell.end_to_end:
            if m["name"] in e2e and e2e[m["name"]] is not None:
                metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}

    # the check: a seeded sample of the window's answers against the reference
    k = cfg["check"]["sample"]
    if fam.streams_tokens:
        pool = [r for r in w["recs"] if r.out is not None and r.done_t is not None
                and w["t0"] <= r.done_t <= w["t_end"]]
        picked = fam.sample(pool, seed, k)
    else:
        picked = fam.sample([r for r in in_window(w) if r.req is not None], seed, k)
        finish_late(server, fam, w, picked)
    never = sum(1 for r in picked if r.out is None)
    picked = [r for r in picked if r.out is not None]
    del server, hooks
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    limits = cfg["check"]["limits"]
    readings = fam.check(cfg, params, cal, picked, device) if picked else {}
    checks, correct = judge(readings, limits, never, len(picked))
    readings["checked"] = len(picked)
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name() if cuda else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if trace and trace_sum is None and w["win"] is not None:
        result["trace_note"] = getattr(w["win"], "note", "no trace read")
    if trace and trace_sum is not None:
        result["device"]["busy_s"] = trace_sum["busy_s"]
        result["device"]["window_s"] = trace_sum["window_s"]
        result["breakdown"] = {"device_ops": trace_sum["device_ops"], "idle_gaps": trace_sum["idle_gaps"]}
    result["readings"] = readings
    result["environment"] = env
    if control and picked:
        # the control put in the program's place, judged by the same limits
        result["control_readings"] = fam.control(cfg, params, cal, picked, device)
        result["control_checks"], result["control_correct"] = judge(result["control_readings"], limits,
                                                                    0, len(picked))
        if hasattr(fam, "faults"):
            # faults planted in the reference put in the program's place
            result["fault_readings"] = fam.faults(cfg, params, cal, picked, device)
            result["fault_correct"] = {k: judge(v, limits, 0, len(picked))[1]
                                       for k, v in result["fault_readings"].items()}
    result["threshold"] = cal["threshold"]
    result["checks"] = checks
    return result


def judge(readings: Dict, limits: Dict, never: int, checked: int):
    """The compared numbers beside their limits, and whether every one is
    within its limit: ``readings`` from ``fam.check`` (the program's) or
    ``fam.control`` (the control's), ``never`` sampled answers that never
    came, ``checked`` answers compared."""
    checks = {name: {"value": readings.get(name), "limit": lim} for name, lim in limits.items()}
    checks["unanswered"] = {"value": never, "limit": 0}
    correct = checked > 0 and all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return checks, bool(correct)


def print_result(result: Dict) -> int:
    """The check's numbers last on standard error, the result line last on
    standard output; the exit code (1 where a forbidden module is loaded in
    this process as the result is about to be printed, after the window,
    the reference and any control: then no result is printed)."""
    loaded = forbidden_modules()
    if loaded:
        print(f"loaded in the measuring process: {', '.join(loaded)}", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0

"""Traced runs of a cell with the port's own span recorder on, and off, in
alternating turns, seed after seed in one process.

    python3 portbench/trace_program.py --workload NAME --seconds S --seeds 11,12,13 [--out F]

For each seed: a traced run with the recorder off, then one with it on (the
order alternates by seed).  One JSON line per run: ``correct``, the
cell's per-layer metrics, the steps and sentences per second over the
window's host part, and, with the recorder on, the readers of the
program's spans (``metrics/sched.self_ms_per_step.py`` and its
neighbours, given the recorder as ``ctx["program"]``), the traced
window's idle time by the innermost program span (``program.idle_gaps``),
the shares of that idle the program's and the load generator's spans
cover, and the clock check (``program.readback_skew``).  A last line gives
the recorder's host cost per span, on and off, from a loop of this
process's host."""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:1] = [str(ROOT), str(ROOT / "src")]

SPAN_METRICS = [
    {"name": "sched.self_ms_per_step.tput", "unit": "ms"},
    {"name": "engine.lane_load_us.tput", "unit": "us"},
    {"name": "step.host_ms_per_step.tput", "unit": "ms"},
    {"name": "dvfs.host_ms_per_step.tput", "unit": "ms"},
]
# the load generator's own spans, outside the server
GENERATOR = ("generator", "submit", "poll", "wait for an arrival")


def span_cost_ns(n: int = 200_000) -> dict:
    """Host ns of one ``with trace.span(...)`` statement, recorder off and
    on, over a loop of ``n`` less the bare loop."""
    from repro_torch.serving import trace

    def loop(body: bool) -> float:
        t = time.perf_counter_ns()
        if body:
            for i in range(n):
                with trace.span("sched.step", i):
                    pass
        else:
            for i in range(n):
                pass
        return (time.perf_counter_ns() - t) / n

    trace.disable()
    bare = min(loop(False) for _ in range(3))
    off = min(loop(True) for _ in range(3)) - bare
    on = []
    for _ in range(3):
        trace.enable()
        on.append(loop(True) - bare)
        trace.disable()
    return {"off_ns": off, "on_ns": min(on)}


def one_run(harness, cell, seed: int, seconds: float, on: bool) -> dict:
    from portbench import program
    from repro_torch.serving import trace

    got = {}
    rec = trace.enable() if on else None
    base = harness.load_reader

    def load_reader(name):
        read = base(name)

        def with_program(ctx):
            if rec is not None:
                ctx["program"] = rec
            got["ctx"] = ctx
            return read(ctx)
        return with_program

    harness.load_reader = load_reader
    t = time.perf_counter()
    try:
        r = harness.run_cell(cell, seed, seconds, True, "cuda")
    finally:
        harness.load_reader = base
        trace.disable()
    ctx = got["ctx"]
    w = ctx["w"]
    steps = w["tel1"]["dense_steps"] - w["tel0"]["dense_steps"]
    out = {"seed": seed, "recorder": on, "correct": r["correct"], "metrics": r["metrics"],
           "steps_per_s": steps / w["h_seconds"],
           "sentences_per_s": (w["tel1"]["sentences"] - w["tel0"]["sentences"]) / w["h_seconds"],
           "idle_gaps": r.get("breakdown", {}).get("idle_gaps"), "run_s": time.perf_counter() - t}
    if rec is not None and ctx["trace"] is not None:
        recs = rec.records()
        n, _, names = program.steps(recs, *program.host_window(ctx))
        out["spans_per_step"] = sum(names.values()) / n if n else None
        gaps = program.idle_gaps(ctx["trace"], recs, ctx["spans"], top=100)
        idle = sum(s for _, s in gaps)
        ours = {r_[2] for r_ in recs}
        out["program_idle_gaps"] = gaps[:10]
        out["idle_s"] = idle
        out["idle_share_program"] = sum(s for n_, s in gaps if n_ in ours) / idle
        out["idle_share_generator"] = sum(s for n_, s in gaps if n_ in GENERATOR) / idle
        out["idle_share_unlabelled"] = sum(s for n_, s in gaps if n_ not in ours and n_ not in GENERATOR) / idle
        out["readback_skew"] = program.readback_skew(ctx["trace"], recs)
        out["records"] = len(recs)
    return out


def main(argv=None) -> int:
    import argparse
    import dataclasses
    import gc
    import json

    import torch

    from portbench import harness, spec

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    torch.set_num_threads(1)
    cell = spec.load_cell(args.workload, ROOT)
    cell = dataclasses.replace(cell, per_layer=cell.per_layer + SPAN_METRICS)
    out = open(args.out, "a") if args.out else None

    def emit(d):
        line = json.dumps(d)
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        for on in ((False, True) if k % 2 == 0 else (True, False)):
            emit(dict(one_run(harness, cell, seed, args.seconds, on), workload=args.workload))
            gc.collect()
            torch.cuda.empty_cache()
    emit({"span_cost": span_cost_ns(), "card": harness.card_state()})
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The knee of an open-loop cell: one set-up, then a window at each offered
rate, the server drained between windows.

    python3 portbench/sweep.py --workload NAME --seed N --seconds S --rates 1000,2000,4000

One JSON line per rate: offered and completed sentences per second, the
backlog (sent, not answered) at the window's close, and the 95th
percentile latency.  The knee is the highest rate whose backlog does not
grow over the window; the cell's traffic file carries 0.8 x that rate."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:1] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    import argparse
    import json

    import torch

    from portbench import harness, spec, tracing
    from portbench.gen import make as make_traffic
    from portbench.reference import set_tf32

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload, ROOT)
    cfg, fam = cell.config, harness.family(cell.config)
    set_tf32(False)
    params = fam.make_weights(cfg, args.seed, "cuda")
    cal = fam.calibrate(cfg, params, args.seed, "cuda", cell.traffic)
    server = fam.build_server(cfg, params, cal, "cuda")
    fam.warmup(cfg, server, make_traffic(cell.traffic, args.seed, fam.vocab(cfg)))
    rates = [float(r) for r in args.rates.split(",")]
    for i, rate in enumerate(rates):
        traffic = make_traffic(dict(cell.traffic, rate_per_s=rate), args.seed + i, fam.vocab(cfg))
        w = harness.run_window(server, fam, traffic, args.seconds, tracing.Spans(False), False)
        e2e = harness.end_to_end(cell, fam, w)
        half = w["t0"] + args.seconds / 2
        due = harness.in_window(w)
        backlog_mid = sum(1 for r in due if r.due <= half and (r.done_t is None or r.done_t > half))
        backlog_end = sum(1 for r in due if r.done_t is None or r.done_t > w["t_end"])
        print(json.dumps({"rate": rate, "offered_per_s": len(due) / args.seconds,
                          "completed_per_s": e2e["cls_sentences_per_s"], "backlog_mid": backlog_mid,
                          "backlog_end": backlog_end, "p95_ms": e2e["cls_p95_ms"],
                          "lag_p99_ms": harness.stats.percentile(
                              [(r.submit - r.due) * 1e3 for r in due if r.submit], 99)}), flush=True)
        if i + 1 < len(rates):
            server.run()
            server.poll()
            torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())

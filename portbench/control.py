"""The control of a cell's check: the plain reference computed in the
precision below the configuration's (TF32 for float32 with TF32 off) put in
the program's place, judged by the same numbers as the program, seed after
seed in one process.

    python3 portbench/control.py --workload NAME --seconds S --seeds 11,12,13

One JSON line per seed: the program's readings and ``correct``, the
control's readings and ``control_correct`` (the control judged by the same
limits, which it has to fail).  The limits in ``configs/<config>.json`` lie
between the two (PERF.md gives the readings each was set from)."""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:1] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    import argparse
    import gc
    import json

    import torch

    from portbench import harness, spec

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = harness.run_cell(cell, seed, args.seconds, False, "cuda", control=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": r["correct"],
                          "program": r["readings"], "control": r.get("control_readings"),
                          "control_correct": r.get("control_correct"), "control_checks": r.get("control_checks"),
                          "faults": r.get("fault_readings"), "fault_correct": r.get("fault_correct"),
                          "threshold": r["threshold"], "metrics": r["metrics"],
                          "run_s": time.perf_counter() - t}), flush=True)
        del r
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

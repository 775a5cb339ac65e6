"""Run one cell of ``BENCHMARK.json`` once, on the card this process sees.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; the numbers compared with the reference come last, under
``checks``, and again as the last lines of standard error.  Exits non-zero
with no result where the program is absent, where no card is present,
where the cell needs more cards than there are, or where JAX or the JAX
package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:1] = [str(ROOT), str(ROOT / "src")]
# kernel caches at fixed paths inside the checkout, so only a checkout's
# first run builds: the port's nvcc libraries go to build/repro_torch_kernels
# (a path the port fixes), Triton's cache here
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "portbench" / "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import importlib.util

    import torch

    from portbench import harness, spec

    if importlib.util.find_spec("repro_torch") is None:
        print(f"the program under test, repro_torch, is not under {ROOT / 'src'}", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, {torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    torch.set_num_threads(1)             # one host thread: the server's work is the host's
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start=T_START)
    return harness.print_result(result)


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Compare the port's two paths between two checkouts on one NVIDIA GPU.

    python3 ab_paths.py --baseline DIR [--rounds 15] [--out FILE]

DIR is another checkout of the repository (for example the parent commit,
unpacked with `git archive` into a directory that .gitignore lists).  One
process imports `repro_torch` from both checkouts (each under its own set of
modules, swapped into `sys.modules` before each use; each checkout builds
its own kernels) and this checkout's chip_smoke.py for the set-up the paths
share with it.  Three variants:

  * baseline      — DIR;
  * change        — this checkout;
  * change-dense  — this checkout with the serving MLP on PyTorch's dense
                    matmul over the zero-filled pruned weights (cuBLAS)
                    instead of the block-sparse kernel.

The host's speed drifts within a run by more than the variants differ, so
the variants take turns: each round runs one of each, in an order that
rotates from round to round, and the comparison is made round by round.
Measured per variant:

  * serving: drain walls (ms, submit to drained; 32 seeded requests of
    8-128 tokens, 8 lanes, buckets 32/64/128, a shared-clock arbiter, full
    width, as chip_smoke's serving phase; each drain on a fresh server, built
    outside the clock) and the device busy ms of one profiled drain, with
    its device ms by kernel;
  * deployed (baseline and change): walls of DeployedAlbert.classify on
    16 x 128 tokens at full width, early exit at chip_smoke's threshold, and
    the device busy ms of one profiled batch, with its device ms by kernel;
  * enqueue_us: host microseconds per call of the block-sparse and AF
    matmul and layernorm ([2048, 768]) wrappers and of the deployed path's
    attention call, ops.span_attention_op on [16, 128, 12, 64] with every
    head live (in each checkout what the path runs around the span kernel),
    enqueued while the stream is held by a spin kernel (the
    wrapper's Python, its checks and the launch; no device time), the least
    over the rounds (chip_smoke.enqueue_us: the least of three sets of 200
    calls in each round).

Prints the card's name and power limit, one JSON line per variant, then a
line of round-by-round comparisons against the baseline (the median of the
per-round differences, and in how many rounds the variant was faster).
Walls are host-clock times around synchronised runs.
"""
from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MODULES = ("repro_torch.configs.base", "repro_torch.kernels.build", "repro_torch.kernels.dispatch",
           "repro_torch.kernels.adaptivfloat_k", "repro_torch.kernels.block_sparse",
           "repro_torch.kernels.layernorm", "repro_torch.kernels.span_attention", "repro_torch.kernels.ops",
           "repro_torch.models.model", "repro_torch.serving.deploy", "repro_torch.serving.engine",
           "repro_torch.serving.dvfs", "repro_torch.common.device", "repro_torch.core.pruning",
           "repro_torch.core.early_exit", "repro_torch.hwmodel.edgebert_accel",
           "repro_torch.data.synthetic")


def _median(v):
    s = sorted(v)
    return 0.5 * (s[(len(s) - 1) // 2] + s[len(s) // 2])


def _ours(name: str) -> bool:
    return name == "repro_torch" or name.startswith("repro_torch.")


def use(mods: dict) -> None:
    """Make ``mods`` (one checkout's repro_torch modules) the imported ones."""
    for name in [n for n in sys.modules if _ours(n)]:
        del sys.modules[name]
    sys.modules.update(mods)


def load(tree: Path) -> dict:
    """Import repro_torch from ``tree``; returns its modules."""
    use({})
    sys.path.insert(0, str(tree / "src"))
    try:
        for name in MODULES:
            importlib.import_module(name)
    finally:
        sys.path.remove(str(tree / "src"))
    mods = {n: m for n, m in sys.modules.items() if _ours(n)}
    if not Path(mods["repro_torch"].__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"repro_torch came from {mods['repro_torch'].__file__}, not {tree}")
    return mods


def _wall_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


class Variant:
    """One variant's set-up, built with its modules in place: its serving
    context, and (``deployed``) its deployed model and the inputs of the
    enqueue timings."""

    def __init__(self, name: str, mods: dict, dense: bool, deployed: bool):
        import numpy as np
        import torch

        import chip_smoke as cs

        self.name, self.mods, self.dense = name, mods, dense
        use(mods)
        mods["repro_torch.kernels.build"].build()        # every kernel, at once
        dev = torch.device("cuda")
        cfg = mods["repro_torch.configs.base"].get_config("albert_edgebert")
        scfg = cs.serving_config(cfg, span=False)
        self.ctx = cs.serving_setup(scfg, cs.serving_params(scfg, 0, prune=True), dev)
        self.dep = self.tokens = None
        self.calls = {}
        if deployed:
            params = mods["repro_torch.models.model"].init_params(
                cfg, torch.Generator().manual_seed(0), device="cpu")
            self.dep = mods["repro_torch.serving.deploy"].deploy_albert(
                params, cfg, envm_cell="MLC2", seed=0, device=dev)
            self.tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (16, 128))
            self.dep.threshold = 0.0
            self.dep.classify(self.tokens)
            self.dep.threshold = cs.pick_threshold(np.asarray(self.dep.last_entropy_traces))
            g = torch.Generator(device=dev).manual_seed(0)
            mlp = self.ctx["params"]["layer"]["mlp"]
            masks = mods["repro_torch.kernels.dispatch"].mlp_block_masks(mlp)
            xs = torch.randn(1024, mlp["w_up"].shape[0], generator=g, device=dev)
            wq = self.dep.layer["wq"]
            xa = torch.randn(2048, wq.codes.shape[0], generator=g, device=dev)
            bsm = mods["repro_torch.kernels.block_sparse"].block_sparse_matmul
            afm = mods["repro_torch.kernels.adaptivfloat_k"].af_matmul
            ln = mods["repro_torch.kernels.layernorm"].layernorm
            span_op = mods["repro_torch.kernels.ops"].span_attention_op
            xl = torch.randn(2048, 768, generator=g, device=dev)
            gam, bet = torch.randn(768, generator=g, device=dev), torch.randn(768, generator=g, device=dev)
            q, k, v = (torch.randn(16, 128, 12, 64, generator=g, device=dev) for _ in range(3))
            spans = [64] * 12
            self.calls = {"block_sparse_matmul": lambda: bsm(xs, mlp["w_up"], masks["w_up"]),
                          "af_matmul": lambda: afm(xa, wq.codes, wq.e_min),
                          "layernorm": lambda: ln(xl, gam, bet),
                          "span_attention_op": lambda: span_op(q, k, v, spans, causal=False)}
        self.drains, self.batches = [], []
        self.enqueue = {k: [] for k in self.calls}

    def server(self):
        srv = self.ctx["fresh"]()
        if self.dense:
            # the MLP takes h @ w (cuBLAS); a server with replicas keeps one
            # set of masks per replica
            srv._block_masks = [None] * srv.replicas if isinstance(srv._block_masks, list) else None
        return srv

    def round(self, warm: bool) -> None:
        import chip_smoke as cs

        use(self.mods)
        srv = self.server()
        ms = _wall_ms(lambda: cs.serve(srv, self.ctx["requests"]))
        if not warm:
            self.drains.append(ms)
        if self.dep is not None:
            ms = _wall_ms(lambda: self.dep.classify(self.tokens))
            if not warm:
                self.batches.append(ms)
        for k, fn in self.calls.items():
            us = cs.enqueue_us(fn)
            if not warm:
                self.enqueue[k].append(us)

    def record(self) -> dict:
        import chip_smoke as cs

        use(self.mods)
        srv = self.server()
        by_kernel = cs.profile_device(lambda: cs.serve(srv, self.ctx["requests"]))
        out = {"variant": self.name,
               "serving": {"walls": self.drains, "median": _median(self.drains),
                           "device_busy_ms": sum(g["ms"] for g in by_kernel.values()),
                           "device_ms_by_kernel": by_kernel}}
        if self.dep is not None:
            by_kernel = cs.profile_device(lambda: self.dep.classify(self.tokens))
            out["deployed"] = {"walls": self.batches, "median": _median(self.batches),
                               "device_busy_ms": sum(g["ms"] for g in by_kernel.values()),
                               "device_ms_by_kernel": by_kernel}
            out["enqueue_us"] = {k: min(v) for k, v in self.enqueue.items()}
        return out


def paired(base: list, other: list) -> dict:
    """Round-by-round ``other - base`` (ms): median, and rounds faster."""
    diffs = [o - b for b, o in zip(base, other)]
    return {"median_diff_ms": _median(diffs), "median_diff_share": _median(diffs) / _median(base),
            "rounds_faster": sum(d < 0 for d in diffs), "rounds": len(diffs)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, required=True, help="the other checkout's root")
    ap.add_argument("--rounds", type=int, default=15, help="measured rounds (after one warm round)")
    ap.add_argument("--out", type=Path, help="also write every line to this file")
    args = ap.parse_args()
    if not (args.baseline / "src" / "repro_torch").is_dir():
        ap.error("--baseline must be a checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        print("ab_paths: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    base_mods, change_mods = load(args.baseline.resolve()), load(ROOT)
    variants = [Variant("baseline", base_mods, False, True), Variant("change", change_mods, False, True),
                Variant("change-dense", change_mods, True, False)]
    for r in range(args.rounds + 1):
        shift = r % len(variants)
        for v in variants[shift:] + variants[:shift]:
            v.round(warm=r == 0)
    lines = [v.record() for v in variants]
    base, change, dense = variants
    lines.append({"paired": {
        "change_vs_baseline": {"serving": paired(base.drains, change.drains),
                               "deployed": paired(base.batches, change.batches)},
        "change-dense_vs_baseline": {"serving": paired(base.drains, dense.drains)},
        "change-dense_vs_change": {"serving": paired(change.drains, dense.drains)}}})
    for ln in lines:
        print(json.dumps(ln), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"device": smi, "lines": lines}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

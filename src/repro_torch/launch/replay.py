"""Trace replay through the port's full multi-task serving path, the port's
counterpart of the JAX package's ``examples/replay_trace.py``.

    PYTHONPATH=src python -m repro_torch.launch.replay              # on the card
    PYTHONPATH=src python -m repro_torch.launch.replay --smoke --device cpu \
        --requests 64 --verify-determinism

A seeded ``mmpp_multitask`` workload (bursty two-state MMPP arrivals, an
explicit-SLO tier beside best-effort traffic, four tasks of Zipf-skewed
popularity, two length buckets) is generated, saved as JSONL, loaded back
and replayed by ``TraceReplayer`` through per-task ``AdmissionController``s
over a ``ResidencyRouter``: four task servers with their own encoder and
head weights share one embedding table, one ``BatchedDVFSArbiter`` clock
and an SRAM working set that fits two tasks.  So one replay runs admission
quotes, eNVM swap stalls, task-affinity arbitration, EDF lane scheduling and
shared-clock DVFS together, on the hand-written kernels on the card.

It keeps its own copy of the few pieces of the JAX package's trace-replay
harness the example uses (``benchmarks/harness/``, which is not ported):
the ``mmpp_multitask`` spec, ``full_depth_service_s``, ``capacity_rps``,
``build_workload``, the residency branch of ``build_target`` and the
controller set-up (exit threshold at the 30th percentile of first-off-ramp
entropies from a dense profiling pass, predictor calibrated at full
quantile).  It prints the replay summary and, on the card, the wall time,
the fused steps and the wall requests/s.  Weights are random: task i's
from seed ``TASK_SEED + i``, the shared embedding from task 0's.
``--smoke`` runs the smoke config as the harness does (shipped spans, dense
MLP); without it the config is ``albert_edgebert`` at its published width,
span off and the MLP block-pruned, as the card's serving phase runs it.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core.pruning import magnitude_mask
from repro_torch.data.synthetic import SyntheticCLS
from repro_torch.hwmodel.edgebert_accel import albert_layer_stats
from repro_torch.models.model import build_model, init_params
from repro_torch.serving.dvfs import (
    BatchedDVFSArbiter,
    LatencyAwareDVFSController,
    calibrate_predictor,
    no_early_exit_baseline,
)
from repro_torch.serving.residency import (
    ResidencyRouter,
    TaskAffinityPolicy,
    TaskDeployment,
    TaskResidencyManager,
)
from repro_torch.serving.workload import (
    MMPPArrivals,
    ResidencyRouterTarget,
    TierSpec,
    TraceReplayer,
    WorkloadConfig,
    generate_trace,
    load_trace,
    save_trace,
    summaries_identical,
)

# the JAX package's benchmarks/harness/scenarios.py "mmpp_multitask" spec:
# bursty MMPP arrivals (calm ~45% / burst ~180% of conservative capacity)
# over four tasks with Zipf-skewed popularity sharing an SRAM working set
# that fits two; loads are fractions of capacity, dwell in requests
MMPP_MULTITASK: Dict[str, Any] = {
    "requests": 100_000,
    "seed": 0,
    "buckets": [16, 32],
    "lengths": [[16, 0.7], [32, 0.3]],
    "tiers": [["explicit", 0.35, 80.0], ["best_effort", 0.65, None]],
    "tasks": [["mnli", 0.48], ["qqp", 0.24], ["sst2", 0.16], ["qnli", 0.12]],
    "sram_tasks": 2,
    # contract safety under sustained bursts: extra-conservative quotes and
    # a swap-preemption margin (in full-depth services) that covers both
    # out-of-SRAM tasks turning urgent at once
    "admission_headroom": 2.0,
    "affinity_margin_services": 8.0,
    "arrivals": {"kind": "mmpp", "loads": [0.45, 1.8], "mean_dwell_requests": [400, 120]},
}

LANES = 4
TARGET_MULT = 1.5                  # deployment-style latency headroom
BEST_EFFORT_QUEUE = 8 * LANES      # bounded; overflow sheds the oldest
REQUESTS = 2_000                   # the example's trace length
TASK_SEED = 10                     # task i's weights from seed TASK_SEED + i


def full_depth_service_s(ctrl, n_layers: int, buckets) -> Callable[[int], float]:
    """One request's full-depth service at the max operating point, at its
    own bucket's cycle cost: the scale-free SLO and capacity unit."""
    bs = tuple(sorted(int(b) for b in buckets))

    def service_s(length: int) -> float:
        b = next((x for x in bs if x >= int(length)), bs[-1])
        return float(n_layers) * ctrl.cycles_for_seq_len(b) / ctrl.max_op.freq_hz

    return service_s


def capacity_rps(ctrl, n_layers: int, lanes: int, lengths) -> float:
    """Conservative sustainable rate: every lane busy, every request at full
    depth, weighted by the length mixture."""
    svc = full_depth_service_s(ctrl, n_layers, [b for b, _ in lengths])
    wsum = sum(w for _, w in lengths)
    mean_svc = sum(w * svc(b) for b, w in lengths) / wsum
    return float(lanes) / mean_svc


def build_workload(spec: Dict[str, Any], *, ctrl, n_layers: int, lanes: int,
                   seed: Optional[int] = None) -> WorkloadConfig:
    """The spec as a ``WorkloadConfig`` with absolute MMPP rates calibrated
    against this controller's capacity."""
    lengths = tuple((int(b), float(w)) for b, w in spec["lengths"])
    cap = capacity_rps(ctrl, n_layers, lanes, lengths)
    a = spec["arrivals"]
    if a["kind"] != "mmpp":
        raise ValueError(f"only the mmpp arrivals of mmpp_multitask are ported, got {a['kind']!r}")
    rates = tuple(float(load) * cap for load in a["loads"])
    dwell = tuple(float(n) / r for n, r in zip(a["mean_dwell_requests"], rates))
    tiers = tuple(TierSpec(str(n), float(w), None if m is None else float(m))
                  for n, w, m in spec["tiers"])
    return WorkloadConfig(
        arrivals=MMPPArrivals(rates_hz=rates, mean_dwell_s=dwell),
        lengths=lengths, tiers=tiers,
        tasks=tuple((str(t), float(w)) for t, w in spec.get("tasks", [])),
        seed=int(spec.get("seed", 0) if seed is None else seed),
    )


def replay_config(smoke: bool):
    """The smoke config as the harness runs it (float32, shipped spans), or
    ``albert_edgebert`` at its published width with span off (float32)."""
    if smoke:
        return dataclasses.replace(get_smoke_config("albert_edgebert"), dtype="float32",
                                   remat_policy="none")
    cfg = dataclasses.replace(get_config("albert_edgebert"), dtype="float32", remat_policy="none")
    return cfg.with_edgebert(span=dataclasses.replace(cfg.edgebert.span, enabled=False))


def task_params(cfg, tasks, *, prune: bool, seed: int = TASK_SEED) -> Tuple[Any, Dict[str, Any]]:
    """Random params on the CPU, task i's from ``seed + i``; with ``prune``
    the shared layer's w_up/w_down are magnitude-pruned at the config's
    encoder sparsity in 32x32 tiles.  Returns (task 0's embedding, the
    per-task trees)."""
    out = {}
    for i, t in enumerate(tasks):
        p = init_params(cfg, torch.Generator().manual_seed(seed + i), device="cpu")
        if prune:
            mlp = p["layer"]["mlp"]
            for name in ("w_up", "w_down"):
                mlp[name] = mlp[name] * magnitude_mask(mlp[name], cfg.edgebert.prune.encoder_sparsity,
                                                       block_size=32)
        out[t] = p
    return out[tasks[0]]["embed"], out


def calibrate(cfg, params, buckets):
    """The controller set-up of the harness: the exit threshold at the 30th
    percentile of first-off-ramp entropies over 16 seeded sentences (a dense
    profiling pass of ``params``), and a factory of controllers over the
    ALBERT layer stats at the largest bucket, target ``TARGET_MULT`` x the
    no-exit latency, with the Alg. 1 LUT calibrated at full quantile on two
    more batches.  Returns (cfg with the threshold, ctrl_factory)."""
    data = SyntheticCLS(cfg.vocab_size, 32, 16, num_classes=cfg.edgebert.early_exit.num_classes,
                        seed=0)
    with torch.no_grad():
        out = build_model(cfg).apply_train(params, {"tokens": data.batch(0)["tokens"]})
    thr = float(np.quantile(out.all_entropies[0].cpu().numpy(), 0.3))
    cfg = cfg.with_edgebert(early_exit=dataclasses.replace(cfg.edgebert.early_exit,
                                                           entropy_threshold=thr))
    stats = albert_layer_stats(seq_len=max(buckets))
    stats.n_layers = cfg.n_layers
    target = no_early_exit_baseline(stats)["latency_s"] * TARGET_MULT
    predictor = calibrate_predictor(build_model(cfg), params,
                                    [data.batch(100 + i) for i in range(2)], quantile=1.0)

    def ctrl_factory():
        return LatencyAwareDVFSController(stats, target, predictor=predictor)

    return cfg, ctrl_factory


class RecordingRouterTarget(ResidencyRouterTarget):
    """A ``ResidencyRouterTarget`` that keeps, for every request ``poll()``
    releases, the task that served it and its exit layer (``record``, uid ->
    (task, exit layer)), its first off-ramp entropy (``first_entropy``, the
    Alg. 1 LUT input) and its logits (``logits``): memory grows with the
    trace, so it is for checks."""

    def __init__(self, router, **kw):
        super().__init__(router, **kw)
        self.record: Dict[int, Tuple[str, int]] = {}
        self.first_entropy: Dict[int, float] = {}
        self.logits: Dict[int, np.ndarray] = {}

    def poll(self):
        out = []
        for name, srv in self.router.tasks.items():
            got = srv.poll()
            for r in got:
                self.record[r.uid] = (name, r.exit_layer)
                self.first_entropy[r.uid] = r.entropy_trace[0]
                self.logits[r.uid] = np.asarray(r.result, np.float64)
            out.extend(got)
        return out


class Stack(NamedTuple):
    """What every replay of one set-up shares: the config with its exit
    threshold, the shared embedding and per-task params (on the CPU), the
    controller factory, the workload and its full-depth service pricing."""
    cfg: Any
    embed: Any
    by_task: Dict[str, Any]
    ctrl_factory: Callable[[], LatencyAwareDVFSController]
    wl: WorkloadConfig
    svc: Callable[[int], float]


def build_stack(cfg, tasks, *, prune: bool = False, params=None,
                seed: Optional[int] = None) -> Stack:
    """The replay set-up of ``MMPP_MULTITASK``: per-task params (``params``
    = (shared embedding, per-task trees), else ``task_params``), the
    controller set-up on task 0's params (``calibrate``), and the workload
    calibrated against that controller's capacity (``seed``: the spec's by
    default)."""
    spec = MMPP_MULTITASK
    buckets = tuple(int(b) for b in spec["buckets"])
    embed, by_task = task_params(cfg, tasks, prune=prune) if params is None else params
    cfg, ctrl_factory = calibrate(cfg, by_task[tasks[0]], buckets)
    ctrl = ctrl_factory()
    svc = full_depth_service_s(ctrl, cfg.n_layers, buckets)
    wl = build_workload(spec, ctrl=ctrl, n_layers=cfg.n_layers, lanes=LANES, seed=seed)
    return Stack(cfg, embed, by_task, ctrl_factory, wl, svc)


def build_target(cfg, shared_embed, params_by_task: Dict[str, Any], ctrl_factory, *,
                 device="cuda", target_cls=ResidencyRouterTarget):
    """A fresh replay target: per-task admission over a ``ResidencyRouter``
    whose task servers share one arbiter and a working set of
    ``spec["sram_tasks"]`` task footprints, each task deployed at
    occupancy 0.4 with 6 of 12 heads off (the harness's residency branch)."""
    spec = MMPP_MULTITASK
    buckets = tuple(int(b) for b in spec["buckets"])
    tasks = [t for t, _ in spec["tasks"]]
    ctrl = ctrl_factory()
    svc = full_depth_service_s(ctrl, cfg.n_layers, buckets)
    margin = float(spec.get("affinity_margin_services", 4.0)) * svc(max(buckets))
    deps = {t: TaskDeployment(t, n_params=11e6, pruning_occupancy=0.4,
                              spans=(0,) * 6 + (64,) * 6) for t in tasks}
    res = TaskResidencyManager(
        deps, sram_bytes=float(spec.get("sram_tasks", 2)) * deps[tasks[0]].storage()["total_bytes"])
    router = ResidencyRouter(
        build_model(cfg), shared_embed, {t: params_by_task[t] for t in tasks},
        residency=res, deployments=deps,
        task_policy=TaskAffinityPolicy(preempt_slack_s=margin),
        arbiter=BatchedDVFSArbiter(ctrl_factory()), buckets=buckets, batch_lanes=LANES,
        device=device,
    )
    adm = {"max_best_effort_queue": BEST_EFFORT_QUEUE,
           "headroom": float(spec.get("admission_headroom", 1.25))}
    return target_cls(router, admission_kwargs=adm)


def fused_steps(target) -> int:
    return sum(srv.telemetry()["dense_steps"] for srv in target.router.tasks.values())


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true", help="the smoke config (4 layers, d 64)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--requests", type=int, default=REQUESTS)
    ap.add_argument("--seed", type=int, default=None,
                    help="workload and token seed (default: the spec's)")
    ap.add_argument("--verify-determinism", action="store_true",
                    help="replay the regenerated trace on a fresh stack and require a "
                         "bit-identical summary")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    spec = MMPP_MULTITASK
    seed = int(spec["seed"] if args.seed is None else args.seed)
    tasks = [t for t, _ in spec["tasks"]]

    st = build_stack(replay_config(args.smoke), tasks, prune=not args.smoke, seed=seed)
    cfg, wl, svc = st.cfg, st.wl, st.svc

    def fresh():
        return build_target(cfg, st.embed, st.by_task, st.ctrl_factory, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # generate -> save -> load: the JSONL round trip is exact
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.jsonl")
        n = save_trace(path, generate_trace(wl, args.requests, service_s=svc))
        target = fresh()
        sync()
        t0 = time.perf_counter()
        summary = TraceReplayer(target, vocab_size=cfg.vocab_size, token_seed=seed).replay(
            load_trace(path))
        sync()
        wall_s = time.perf_counter() - t0
    steps = fused_steps(target)
    print(f"replayed {summary['requests']} of {n} saved events on {dev.type} "
          f"({cfg.name}, {cfg.n_layers} layers, d {cfg.d_model}) over "
          f"{summary['modeled_span_s']:.4g} modeled s", flush=True)
    print(f"completed {summary['completed']} ({summary['completed_explicit']} explicit-SLO / "
          f"{summary['completed_best_effort']} best-effort), rejected {summary['rejected']}, "
          f"shed {summary['shed']}; accepted-SLO misses {summary['accepted_slo_misses']}", flush=True)
    print(f"queue delay p50/p95/p99 {summary['queue_delay_s_p50']:.4g} / "
          f"{summary['queue_delay_s_p95']:.4g} / {summary['queue_delay_s_p99']:.4g} modeled s; "
          f"energy {summary['energy_per_request_j']:.4g} J/request (modeled); "
          f"{summary.get('task_swaps', 0)} task swaps, "
          f"{target.router.task_switches} task switches", flush=True)
    print(f"step builds {summary['step_traces']}, at most "
          f"{summary['max_traces_per_bucket_replica']} per bucket; "
          f"peak outstanding {summary['peak_outstanding']}", flush=True)
    if dev.type == "cuda":
        print(f"wall {wall_s * 1e3:.1f} ms, {steps} fused steps, "
              f"{summary['completed'] / wall_s:.1f} requests/s (wall)", flush=True)
    if args.verify_determinism:
        again = TraceReplayer(fresh(), vocab_size=cfg.vocab_size, token_seed=seed).replay(
            generate_trace(wl, args.requests, service_s=svc))
        if not summaries_identical(summary, again):
            raise SystemExit("same-seed replays diverged")
        print("same-seed regenerated replay: bit-identical summary", flush=True)
    return summary


if __name__ == "__main__":
    main()

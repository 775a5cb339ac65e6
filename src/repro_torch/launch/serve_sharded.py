"""Lane-sharded serving: one scheduler over replicas, each replica on its own
device and its own DVFS clock domain; the port's counterpart of the JAX
package's ``examples/serve_sharded.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve_sharded          # cuda:0 and cuda:1
    PYTHONPATH=src python -m repro_torch.launch.serve_sharded --devices cuda:0,cuda:0
    PYTHONPATH=src python -m repro_torch.launch.serve_sharded --smoke --device cpu

One ``LaneScheduler`` drives ``replicas x lanes`` lanes of a
``ClassifierServer``: lane slab r is what replica r computes, on its device,
and each replica is a clock domain of its own (one ``BatchedDVFSArbiter``
per replica, never below the fleet's tightest lane requirement, every clock
moved to the fleet's after each fused step).  Admission quotes each
replica and routes every accepted contract with ``LeastLoadedPlacement``:
the request is pinned, and only its replica's lanes take it.  The run
serves best-effort traffic over both buckets, then 2R contracts admitted at
their own quote; it prints the placements, the builds per (bucket,
replicas) and each domain's clock, energy, operating-point switches and
switching stall, and it fails unless every accepted SLO is met and each
(bucket, replicas) was built once.

Without ``--devices``, ``--replicas R`` on the card takes ``cuda:0 ..
cuda:R-1`` and fails where fewer cards exist; ``--devices`` names each
replica's device, one card as often as wanted.  ``--smoke`` runs the smoke
config as the JAX example does (shipped spans); without it the config is
``albert_edgebert`` at its published width, span off and the MLP
block-pruned in 32 x 32 tiles, as the card's serving phase runs it.
Weights are random, from seed 0; each replica has 2 lanes.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.common.device import resolve_device
from repro_torch.data.synthetic import SyntheticCLS
from repro_torch.hwmodel.edgebert_accel import albert_layer_stats
from repro_torch.launch.replay import replay_config, task_params
from repro_torch.models.model import build_model
from repro_torch.serving.admission import AdmissionController, LeastLoadedPlacement
from repro_torch.serving.dvfs import BatchedDVFSArbiter, LatencyAwareDVFSController, no_early_exit_baseline
from repro_torch.serving.engine import ClassifierServer, Request

REPLICAS, LANES, BUCKETS, SEED = 2, 2, (16, 32), 0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--replicas", type=int, default=None,
                    help=f"replica count (default {REPLICAS}, or the length of --devices)")
    ap.add_argument("--devices", default=None, help="one device per replica, comma-separated")
    args = ap.parse_args(argv)
    devices = args.devices.split(",") if args.devices else None
    replicas = args.replicas if args.replicas is not None else (1 if devices else REPLICAS)
    resolve_device(args.device)              # no card and no --device cpu: raise before the set-up

    cfg = replay_config(args.smoke)
    model = build_model(cfg)
    params = task_params(cfg, ("sharded",), prune=not args.smoke, seed=SEED)[1]["sharded"]
    data = SyntheticCLS(cfg.vocab_size, 32, 16, num_classes=cfg.edgebert.early_exit.num_classes, seed=SEED)
    stats = albert_layer_stats(seq_len=max(BUCKETS))
    stats.n_layers = cfg.n_layers
    ctrl = LatencyAwareDVFSController(stats, no_early_exit_baseline(stats)["latency_s"] * 1.5)

    srv = ClassifierServer(model, params, batch_lanes=LANES, arbiter=BatchedDVFSArbiter(ctrl),
                           buckets=BUCKETS, replicas=replicas, devices=devices, device=args.device)
    ac = AdmissionController(srv, placement=LeastLoadedPlacement())
    print(f"devices={[str(d) for d in srv.devices]} replicas={srv.replicas} "
          f"lanes={srv.lanes} ({srv.lanes_per_replica}/replica)", flush=True)

    # best-effort traffic over both buckets, then explicit contracts admitted
    # at their own per-replica quote (and pinned by the placement)
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    uid = 0
    for i in range(4 * srv.lanes):
        n = int(rng.integers(6, 32))
        srv.submit(Request(uid=uid, tokens=np.asarray(data.batch(100 + i)["tokens"][0][:n], np.int32)))
        uid += 1
    placement = []
    for i in range(2 * srv.replicas):
        toks = np.asarray(data.batch(300 + i)["tokens"][0][:12], np.int32)
        q = ac.quote(Request(uid=uid, tokens=toks, deadline_s=1e9))
        d = ac.submit(Request(uid=uid, tokens=toks, deadline_s=q.min_deadline_s))
        if not d.admitted:
            raise SystemExit(f"request {uid}: a contract at its own quote was rejected")
        placement.append((uid, q.replica))
        uid += 1
    srv.run()
    wall = time.perf_counter() - t0

    st = srv.telemetry()
    domains = [{"replica": r, "device": str(srv.devices[r]), "clock_s": arb.now_s,
                "energy_j": arb.compute_energy_j, "op_switches": arb.op_switches,
                "switch_time_s": arb.switch_time_s} for r, arb in enumerate(srv.arbiters)]
    print(f"retired {st['sentences']} requests in {st['dense_steps']} fused steps "
          f"(avg exit {st['avg_exit_layer']:.2f}/{cfg.n_layers}) on {args.device} in {wall:.2f} s")
    print("placement (uid -> replica):", placement)
    print("builds per (bucket x replicas):", st["step_traces_per_bucket_replica"])
    print(f"accepted={st['accepted']} accepted_slo_misses={st['accepted_slo_misses']}")
    for d in domains:
        print(f"replica {d['replica']} ({d['device']}): clock={d['clock_s'] * 1e3:.2f}ms "
              f"energy={d['energy_j']:.3e}J op_switches={d['op_switches']} "
              f"stall={d['switch_time_s'] * 1e6:.1f}us", flush=True)
    if st["accepted_slo_misses"] != 0:
        raise SystemExit(f"{st['accepted_slo_misses']} accepted SLOs missed")
    if set(st["step_traces_per_bucket_replica"].values()) != {1}:
        raise SystemExit(f"a (bucket, replicas) built more than once: {st['step_traces_per_bucket_replica']}")
    print("ok: one build per (bucket, replicas), zero accepted-SLO misses", flush=True)
    return {**st, "placement": placement, "domains": domains, "wall_s": wall,
            "devices": [str(d) for d in srv.devices]}


if __name__ == "__main__":
    main()

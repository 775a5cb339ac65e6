"""The training entry point, the port of the JAX package's ``launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch albert_edgebert --steps 200 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --arch albert_base --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2_1p2b --smoke --device cpu --steps 5

It trains on the card unless ``--device cpu`` is given.  A config with any
EdgeBERT training feature (pruning, spans, early exit: ``albert_edgebert``)
runs the paper's two-phase procedure (``EdgeBertTrainer``; ``--phase2``
adds the off-ramp phase) and checkpoints its params at the end.  Any other
config (``albert_base``, or a decoder on ``SyntheticLM`` tokens: the dense,
MoE, ssm and hybrid families) runs the generic resumable route:
``make_train_step`` with ``--microbatches``, a checkpoint every
``--save-every`` steps holding ``{"params", "opt"}`` (the AdamW state), and
auto-resume from the newest one, whichever package wrote it (the layout
and keys are the JAX package's).  The encdec and vlm families' training
forward also needs encoder frames or image embeddings, which
``SyntheticLM`` does not make (the JAX launcher fails on the missing key):
the launcher exits with a message saying so.

Production semantics, as in the reference: deterministic, seekable data (a
pure function of (seed, step), so a restart is exact); atomic checkpoints,
auto-resume from LATEST and a SIGTERM preemption checkpoint
(``CheckpointManager``); a heartbeat that logs step latency percentiles so
a scheduler watching the log can flag stragglers.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.common.device import resolve_device
from repro_torch.common.util import logger
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.data.synthetic import SyntheticCLS, SyntheticLM
from repro_torch.models.model import build_model, init_params
from repro_torch.training.optim import AdamWConfig, adamw_init
from repro_torch.training.train_loop import EdgeBertTrainer, TrainerConfig, make_train_step, to_batch

# checkpoints go under the checkout's build/ unless --ckpt-dir says otherwise
DEFAULT_CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_ckpt"


class Heartbeat:
    """Step-latency telemetry: every ``window`` steps it logs p50 / p95 (a
    fleet scheduler watching the log can evict stragglers)."""

    def __init__(self, window: int = 50):
        self.times: List[float] = []
        self.window = window

    def beat(self, dt: float, step: int) -> None:
        self.times.append(dt)
        if len(self.times) >= self.window:
            arr = np.array(self.times)
            logger.info("heartbeat step=%d p50=%.3fs p95=%.3fs", step,
                        float(np.percentile(arr, 50)), float(np.percentile(arr, 95)))
            self.times = []


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="albert_edgebert")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phase2", action="store_true", help="run the off-ramp phase too")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, dtype="float32", remat_policy="none")
    if cfg.family in ("encdec", "vlm"):
        key = "enc_input" if cfg.family == "encdec" else "image_embeds"
        raise SystemExit(f'{args.arch}: the {cfg.family} training forward needs batch["{key}"] beside the tokens, '
                         "and SyntheticLM makes tokens alone; train it through make_train_step with that input")
    dev = resolve_device(args.device)
    model = build_model(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(args.seed), device=dev)

    if cfg.num_classes:
        data = SyntheticCLS(cfg.vocab_size, args.seq, args.batch, num_classes=cfg.num_classes, seed=args.seed)
    else:
        data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps, warmup_steps=max(args.steps // 10, 1))

    ckpt = CheckpointManager(args.ckpt_dir, save_every=args.save_every)
    ckpt.install_preemption_handler()

    eb = cfg.edgebert
    if eb.prune.enabled or eb.span.enabled or eb.early_exit.enabled:
        # the paper's two-phase procedure
        tcfg = TrainerConfig(phase1_steps=args.steps, phase2_steps=args.steps // 2 if args.phase2 else 0,
                             opt=opt_cfg)
        trainer = EdgeBertTrainer(model, tcfg)
        params, _, hist = trainer.phase1(params, data)
        ckpt.maybe_save(args.steps, {"params": params}, force=True)
        if args.phase2:
            params, _ = trainer.phase2(params, data)
            ckpt.maybe_save(args.steps * 2, {"params": params}, force=True)
        logger.info("final loss=%.4f acc=%.3f", hist[-1]["loss"], hist[-1].get("acc", 0.0))
        return {"route": "two_phase", "final": hist[-1], "params": params}

    # the generic route, with resume
    opt_state = adamw_init(params)
    start_step = 0
    if ckpt.latest_step() is not None:
        state, manifest = ckpt.restore_latest({"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        start_step = manifest["step"]
        logger.info("resumed from step %d", start_step)

    step_fn = make_train_step(model, opt_cfg, microbatches=args.microbatches)
    hb = Heartbeat()
    metrics = {}
    for step in range(start_step, args.steps):
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, to_batch(data.batch(step), dev))
        loss = float(metrics["loss"])          # waits for the step, so the beat times it
        hb.beat(time.time() - t0, step)
        if step % 20 == 0:
            logger.info("step=%d loss=%.4f", step, loss)
        ckpt.maybe_save(step, {"params": params, "opt": opt_state})
        if ckpt.preempted:
            logger.warning("preempted: exiting after checkpoint")
            return {"route": "generic", "preempted_at": step, "params": params, "opt": opt_state}
    ckpt.maybe_save(args.steps, {"params": params, "opt": opt_state}, force=True)
    if metrics:
        logger.info("done: final loss=%.4f", float(metrics["loss"]))
    return {"route": "generic", "start_step": start_step, "params": params, "opt": opt_state,
            "final": {k: float(v) for k, v in metrics.items()}}


if __name__ == "__main__":
    main()

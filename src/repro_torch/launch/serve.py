"""Serving entry point, the JAX package's ``launch/serve.py``: early-exit
classification (the paper's workload) through the continuation-batching
``ClassifierServer``, or LM decode through the ``DecoderServer``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch albert_edgebert
    PYTHONPATH=src python -m repro_torch.launch.serve --arch albert_edgebert \
        --smoke --device cpu --requests 32 --threshold 1.05
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek_7b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_moe_a2p7b --smoke --device cpu

It runs on the card unless ``--device cpu`` is given; weights are random
from ``--seed`` (float32).  The decoder serves ``SyntheticLM`` prompts cut
to 16 tokens with ``--max-new-tokens`` each, at full depth, or with
per-token early exit at ``--threshold``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.common.device import resolve_device
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.data.synthetic import SyntheticCLS, SyntheticLM
from repro_torch.models.model import build_model, init_params
from repro_torch.serving.engine import ClassifierServer, DecoderServer, Request


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="albert_edgebert")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--threshold", type=float, default=None)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, dtype="float32", remat_policy="none")
    if cfg.family in ("dense", "moe"):
        return _serve_decoder(cfg, args)
    if cfg.family != "albert" or not cfg.edgebert.early_exit.enabled:
        raise SystemExit(f"{args.arch}: only early-exit albert classification and the dense and MoE decoders "
                         "are ported")
    if args.threshold is not None:
        cfg = cfg.with_edgebert(early_exit=dataclasses.replace(
            cfg.edgebert.early_exit, entropy_threshold=args.threshold))
    model = build_model(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(args.seed), device=args.device)

    t0 = time.time()
    data = SyntheticCLS(cfg.vocab_size, args.seq, args.requests,
                        num_classes=cfg.edgebert.early_exit.num_classes, seed=args.seed)
    batch = data.batch(0)
    server = ClassifierServer(model, params, batch_lanes=args.lanes, device=args.device)
    for i in range(args.requests):
        server.submit(Request(uid=i, tokens=batch["tokens"][i]))
    stats = server.run()
    print(
        f"served {stats['sentences']} sentences on {args.device}: "
        f"avg_exit={stats['avg_exit_layer']:.2f}/{cfg.n_layers} "
        f"runtime_savings={100 * stats['runtime_savings']:.1f}% "
        f"layer_calls={stats['layer_calls']} ({time.time() - t0:.1f}s)",
        flush=True,
    )
    return stats


def _serve_decoder(cfg, args) -> dict:
    """The decode branch: random weights drawn on the serving device."""
    model = build_model(cfg)
    dev = resolve_device(args.device)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    t0 = time.time()
    batch = SyntheticLM(cfg.vocab_size, args.seq, args.requests, seed=args.seed).batch(0)
    server = DecoderServer(model, params, batch_lanes=args.lanes,
                           max_seq=args.seq + args.max_new_tokens + 8,
                           exit_threshold=args.threshold, device=args.device)
    for i in range(args.requests):
        server.submit(Request(uid=i, tokens=batch["tokens"][i][:16], max_new_tokens=args.max_new_tokens))
    stats = server.run()
    print(
        f"decoded {stats['tokens']} tokens for {stats['completed']} requests on {args.device}: "
        f"avg_token_exit={stats['avg_token_exit_layer']:.2f}/{cfg.n_layers} "
        f"decode_steps={stats['decode_steps']} ({time.time() - t0:.1f}s)",
        flush=True,
    )
    return stats

if __name__ == "__main__":
    main()

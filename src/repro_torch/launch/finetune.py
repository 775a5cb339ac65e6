"""The EdgeBERT deployment pipeline end to end (paper Fig. 6), the port's
counterpart of the JAX package's ``examples/finetune_edgebert.py``:

  phase 1  fine-tune with magnitude or movement pruning + adaptive-span
           learning (+ distillation from a teacher, where one is given)
  phase 2  freeze the backbone, train the early-exit off-ramp
  deploy   AdaptivFloat-8 quantization + bitmask encoding + eNVM (MLC2)
           embedding storage, then early-exit serving of the trained
           weights: ``ClassifierServer`` (the serving kernels, the MLP
           block-sparse where pruning left whole tiles empty) and
           ``deploy_albert`` (the deployed kernels, attention at the
           learned integer spans)

    PYTHONPATH=src python -m repro_torch.launch.finetune --device cpu     # smoke size, seconds
    PYTHONPATH=src python -m repro_torch.launch.finetune                  # the same on the card
    PYTHONPATH=src python -m repro_torch.launch.finetune --full --steps 40

Smoke size by default; ``--full`` gives the published ALBERT widths.  It
trains on the card unless ``--device cpu`` is given; weights are random
from seed 0 (``init_params``), the data ``SyntheticCLS``.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.configs.base import ModelConfig, PruneConfig, SpanConfig, get_config, get_smoke_config
from repro_torch.core import bitmask as bm
from repro_torch.core import envm
from repro_torch.core.adaptive_span import hard_spans, span_flop_factor
from repro_torch.core.adaptivfloat import AFFormat, quantize_pytree
from repro_torch.core.pruning import measured_sparsity
from repro_torch.data.synthetic import SyntheticCLS
from repro_torch.models.model import build_model, init_params
from repro_torch.serving.deploy import deploy_albert
from repro_torch.serving.engine import ClassifierServer, Request
from repro_torch.training.optim import AdamWConfig
from repro_torch.training.train_loop import EdgeBertTrainer, TrainerConfig

# the example's span and optimizer settings.  Its learning rate (2e-3)
# suits the smoke widths only: at the published width Adam's first steps
# saturate the 768-wide tanh pooler and nothing is learned (on an H100 the
# loss stayed at chance, as it did at 1e-4 with the example's 5 warmup
# steps), so the full config takes 5e-5, at which it learns
SPAN = SpanConfig(enabled=True, max_span=128, ramp=16, loss_coef=0.02, init_span=96.0)
SPAN_LR_MULT = 300.0
LR = {"smoke": 2e-3, "full": 5e-5}


def finetune_config(full: bool, steps: int, method: str = "magnitude", sparsity: float = 0.5,
                    block_size: int = 1) -> ModelConfig:
    """``albert_edgebert`` (published widths with ``full``) in float32 with
    the example's pruning schedule (masks every 5 steps, final sparsity 10
    steps before the end) and spans."""
    cfg = get_config("albert_edgebert") if full else get_smoke_config("albert_edgebert")
    cfg = dataclasses.replace(cfg, dtype="float32", remat_policy="none")
    return cfg.with_edgebert(
        prune=PruneConfig(enabled=True, method=method, encoder_sparsity=sparsity, embedding_sparsity=0.6,
                          end_step=steps - 10, update_every=5, block_size=block_size),
        span=SPAN,
    )


def trainer_for(model, steps: int, phase2_steps: Optional[int] = None, teacher_params=None,
                lr: float = LR["smoke"]) -> EdgeBertTrainer:
    return EdgeBertTrainer(
        model,
        TrainerConfig(phase1_steps=steps, phase2_steps=steps // 2 if phase2_steps is None else phase2_steps,
                      opt=AdamWConfig(lr=lr, warmup_steps=5, total_steps=steps * 2,
                                      span_lr_mult=SPAN_LR_MULT)),
        teacher_params=teacher_params,
    )


def quantize_for_deploy(params: Dict[str, Any], seed: int = 0) -> tuple:
    """AF(8, 3) post-quantization of every leaf but the norms, then the
    embedding table through the eNVM (MLC2) round trip.  Returns
    ``(params_q, stats)``: the bitmask storage of the table and the faults
    injected."""
    params_q = quantize_pytree(params, AFFormat(8, 3), predicate=lambda path, _: "norm" not in path.lower())
    emb = params_q["embed"]["tok"].cpu().numpy()
    emb_rb, stats = envm.store_and_readback(emb, data_cell="MLC2", seed=seed)
    tok = torch.from_numpy(emb_rb).to(params_q["embed"]["tok"].device)
    params_q = dict(params_q, embed=dict(params_q["embed"], tok=tok))
    storage = bm.storage_bytes(bm.encode(emb), value_bits=8)
    return params_q, {"embedding_bytes": storage["total_bytes"], "compression": storage["compression"],
                      "code_faults": stats["n_code_faults"], "mask_bit_flips": stats["n_mask_bit_flips"]}


def serve_trained(model, params_q: Dict[str, Any], tokens: np.ndarray, device, lanes: int = 4,
                  arbiter=None) -> Dict[str, Any]:
    """A ``ClassifierServer`` drain of ``tokens`` on the trained, quantized
    weights (the MLP block-sparse where whole tiles are empty)."""
    server = ClassifierServer(model, params_q, batch_lanes=lanes, arbiter=arbiter, device=device)
    reqs = [Request(uid=i, tokens=row) for i, row in enumerate(tokens)]
    for r in reqs:
        server.submit(r)
    stats = server.run()
    stats["exits"] = [int(r.exit_layer) for r in reqs]
    stats["requests"] = reqs
    return stats


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--method", choices=("magnitude", "movement"), default="magnitude")
    ap.add_argument("--sparsity", type=float, default=0.5)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = finetune_config(args.full, args.steps, args.method, args.sparsity)
    model = build_model(cfg)
    data = SyntheticCLS(cfg.vocab_size, 32, 16, num_classes=3)
    trainer = trainer_for(model, args.steps, lr=LR["full" if args.full else "smoke"])
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)

    print("== phase 1: prune + span learning ==")
    params, prune_state, h1 = trainer.phase1(params, data)
    sparsity = measured_sparsity(params, prune_state)["sparsity"]
    spans = hard_spans(params["span_z"].cpu().numpy()[0])
    print(f"   sparsity: {sparsity:.2f}")
    print(f"   learned spans: {[int(x) for x in spans]}  "
          f"(score FLOPs kept: {span_flop_factor(spans, cfg.n_heads, 128):.3f})")

    print("== phase 2: off-ramp highway training ==")
    params, h2 = trainer.phase2(params, data)

    print("== deploy: AF8 quantization + eNVM embeddings ==")
    params_q, qstats = quantize_for_deploy(params)
    print(f"   embedding: {qstats['embedding_bytes'] / 1e3:.1f} KB bitmask-encoded "
          f"({qstats['compression']:.2f}x vs dense-8b); {qstats['code_faults']} MLC2 code faults injected")

    print("== serve with early exit ==")
    b = data.batch(9999)
    st = serve_trained(model, params_q, b["tokens"], dev)
    print(f"   avg exit layer {st['avg_exit_layer']:.2f}/{cfg.n_layers} "
          f"-> runtime savings {st['runtime_savings']:.1%} (layer_calls={st['layer_calls']})")
    dep = deploy_albert(params_q, cfg, envm_cell="MLC2", seed=0, device=dev)
    _, exits = dep.classify(b["tokens"])
    print(f"   deployed: spans {[int(x) for x in dep.spans]}, mean exit {float(np.mean(exits)):.2f}/{cfg.n_layers}")
    return {"phase1": h1, "phase2": h2, "sparsity": sparsity, "spans": spans, "quant": qstats,
            "served": st, "deployed_exits": exits, "params": params, "params_q": params_q}


if __name__ == "__main__":
    main()

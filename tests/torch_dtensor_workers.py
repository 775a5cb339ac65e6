"""The rank side of ``tests/test_torch_dtensor_forms.py``: what each of the
four ``gloo`` ranks runs, in a module that imports no JAX (every rank is a
spawned process, and imports this module by name).

Each case places a smoke config's params (float32, seed 0), a seeded batch
and, for prefill and decode, a seeded cache on a (data, model) mesh of the
four ranks, by the dry run's own rules (``launch.dryrun.build_cell`` with
``values``), and runs the dry run's step on those DTensors with
``sharding.dtensor_forms`` installed.  The same values go through the plain
model in every rank: the train step with one microbatch per (data shard,
microbatch) block of rows, and prefill / decode on each data shard's rows,
since the MoE region routes each rank's rows on their own (the JAX
package's ``shard_map`` dispatch); for every other layer the blocks change
nothing.  ``run_rank`` writes, from rank 0, each compared leaf's largest
error over its largest magnitude (at least 1; a gradient's over its own
largest magnitude) and how often each case called each form.
"""
from __future__ import annotations

import json
import os
from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.common.util import tree_leaves_with_path, tree_map
from repro_torch.configs.base import ShapeConfig, get_smoke_config
from repro_torch.data.synthetic import make_batch_specs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.models.model import build_model, init_params
from repro_torch.sharding import dtensor_forms
from repro_torch.sharding.rules import path_to_str
from repro_torch.training.optim import AdamWConfig

MICROBATCHES = 2
SEQ = 16
# Adam's eps at 1e-3: at 1e-8 the first update is lr * sign(g), which flips
# on gradients within rounding of zero
OPT = AdamWConfig(eps=1e-3)
# name -> (arch, (data, model), kind, global batch, config overrides)
CASES = {
    "deepseek_7b/train/2x2": ("deepseek_7b", (2, 2), "train", 8, {}),
    "deepseek_7b/train_sp/2x2": ("deepseek_7b", (2, 2), "train", 8, {"sequence_parallel": True,
                                                                       "sp_batch_axes": ("data",)}),
    "deepseek_7b/prefill/2x2": ("deepseek_7b", (2, 2), "prefill", 4, {}),
    "deepseek_7b/decode/2x2": ("deepseek_7b", (2, 2), "decode", 4, {}),
    "deepseek_7b/decode_sp/2x2": ("deepseek_7b", (2, 2), "decode", 4, {"sequence_parallel": True,
                                                                         "sp_batch_axes": ("data",)}),
    "qwen3_moe_235b/train/2x2": ("qwen3_moe_235b", (2, 2), "train", 8, {}),
    "qwen3_moe_235b/train/1x4": ("qwen3_moe_235b", (1, 4), "train", 4, {}),
    "qwen3_moe_235b/decode/1x4": ("qwen3_moe_235b", (1, 4), "decode", 4, {}),
    "qwen2_moe_a2p7b/train/1x4": ("qwen2_moe_a2p7b", (1, 4), "train", 4, {}),
    "rwkv6_7b/train/2x2": ("rwkv6_7b", (2, 2), "train", 8, {}),
    "rwkv6_7b/decode/2x2": ("rwkv6_7b", (2, 2), "decode", 4, {}),
    "rwkv6_7b/tmix/2x2": ("rwkv6_7b", (2, 2), "tmix", 4, {}),
    "zamba2_1p2b/train/2x2": ("zamba2_1p2b", (2, 2), "train", 8, {}),
    "zamba2_1p2b/decode/2x2": ("zamba2_1p2b", (2, 2), "decode", 4, {}),
    "zamba2_1p2b/decode_b1/2x2": ("zamba2_1p2b", (2, 2), "decode", 1, {}),
    "whisper_medium/prefill/2x2": ("whisper_medium", (2, 2), "prefill", 4, {}),
    "llama3_2_vision_90b/prefill/2x2": ("llama3_2_vision_90b", (2, 2), "prefill", 4, {}),
}
# the forms whose calls each case counts
PROBED = ("_attention_sharded", "_attention_key_blocks", "_split_heads", "_write_rows", "_write_rows_sharded",
          "_per_layer_proj", "_apply_moe_dtensor", "_wkv_sharded", "_lm_loss_sharded", "_sp_constrain",
          "_microbatch")


def _values(cfg, kind: str, batch: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {"params": init_params(cfg, device="cpu"),
           "batch": {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, SEQ)).astype(np.int32))}}
    if kind == "decode":
        out["batch"]["tokens"] = out["batch"]["tokens"][:, :1].contiguous()
    for name, spec in make_batch_specs(cfg, ShapeConfig("values", SEQ, batch, kind)).items():
        if name not in out["batch"]:        # the encoder's frames, the vlm's image
            out["batch"][name] = torch.from_numpy(rng.standard_normal(spec.shape).astype(np.float32) * 0.5)
    if kind != "train":
        cache = build_model(cfg).init_cache(batch, SEQ, device="cpu")
        out["cache"] = tree_map(lambda t: torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32) * 0.5)
                                .to(t.dtype), cache)
    return out


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _rows(tree, lo: int, hi: int, dim: int):
    return tree_map(lambda t: t.narrow(dim, lo, hi - lo).clone(), tree)


def _full(tree):
    return tree_map(lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t, tree)


def _errors(got, want, floor: float = 1.0) -> dict:
    """{leaf path: largest |got - want| over max(floor, largest |want|)}."""
    out = {}
    for (path, g), (_, w) in zip(tree_leaves_with_path(got), tree_leaves_with_path(want)):
        g, w = g.detach().double(), w.detach().double()
        assert g.shape == w.shape, (path_to_str(path), g.shape, w.shape)
        out[path_to_str(path) or "."] = float((g - w).abs().max()) / max(floor, float(w.abs().max())) \
            if w.numel() else 0.0
    return out


def _tmix_case(cfg, mesh, params, batch: int, calls: dict) -> dict:
    """RWKV6's time mix alone (layer 0): rows over the data axis and the
    rules' layout of its params, forward and the gradients of
    sum(out * R).  The whole model's gradients are too ill-conditioned to
    show a fault of the sharded WKV's transpose below 1e-3 (the train
    cases' ``sensitivity``); one layer's are not."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models import rwkv6
    from repro_torch.sharding.rules import param_shardings, placements_of, rules_for

    dmesh = device_mesh(mesh, "cpu")
    sh = param_shardings(params, dmesh, rules_for(cfg, dmesh))["layers"]["tmix"]
    p = tree_map(lambda t: t[0].detach(), params["layers"]["tmix"])
    gen = torch.Generator().manual_seed(0)
    x, R = (torch.randn(batch, SEQ, cfg.d_model, generator=gen) for _ in range(2))

    def grads(p, x, R):
        p = tree_map(lambda t: t.requires_grad_(True), p)
        x = x.requires_grad_(True)
        out = rwkv6.apply_rwkv6(p, x, cfg)[0]
        (out * R).sum().backward()
        return _full({"out": out.detach(), "x": x.grad, "p": tree_map(lambda t: t.grad, p)})

    want = grads(_clone(p), x.clone(), R)
    rows = placements_of(("data",), dmesh)
    pd = tree_map(lambda t, s: distribute_tensor(t.clone(), dmesh, placements_of(s.spec[1:], dmesh)), p, sh)
    with dtensor_forms.installed(cfg), implicit_replication():
        got = grads(pd, distribute_tensor(x.clone(), dmesh, rows), distribute_tensor(R, dmesh, rows))
    return {"errors": {"out": _errors(got["out"], want["out"]), "grads": _errors(
        {"x": got["x"], "p": got["p"]}, {"x": want["x"], "p": want["p"]}, floor=1e-30)}, "calls": calls}


def _run_case(name: str) -> dict:
    from torch.distributed.tensor.experimental import implicit_replication

    arch, (nd, nm), kind, batch, over = CASES[name]
    cfg = replace(get_smoke_config(arch), dtype="float32", **over)
    shape = ShapeConfig(name, SEQ, batch, kind)
    vals = _values(cfg, kind, batch, seed=sum(map(ord, name)))
    pos = torch.from_numpy(np.random.default_rng(1).integers(1, SEQ, batch).astype(np.int64))
    mesh = Mesh(("data", "model"), (nd, nm))

    calls = {k: 0 for k in PROBED}
    real = {k: getattr(dtensor_forms, k) for k in PROBED}

    def counted(k):
        def f(*a, **kw):
            calls[k] += 1
            return real[k](*a, **kw)
        return f

    for k in PROBED:
        setattr(dtensor_forms, k, counted(k))
    if kind == "tmix":
        try:
            return _tmix_case(cfg, mesh, vals["params"], batch, calls)
        finally:
            for k in PROBED:
                setattr(dtensor_forms, k, real[k])
    try:
        with dtensor_forms.installed(cfg):
            fn, args, _, _ = dryrun.build_cell(cfg, shape, mesh, microbatches=MICROBATCHES, values=_clone(vals),
                                               opt_cfg=OPT)
            with implicit_replication():
                if kind == "decode":
                    args = args[:3] + (pos,)
                got = fn(*args)
            got = _full(got)
            cache_got = _full(args[1] if kind == "decode" else args[2]) if kind != "train" else None
    finally:
        for k in PROBED:
            setattr(dtensor_forms, k, real[k])

    one = Mesh(("data", "model"), (1, 1))
    n_shards = nd if batch % nd == 0 else 1
    if kind == "train":
        ref_fn, ref_args, _, _ = dryrun.build_cell(cfg, shape, one, microbatches=MICROBATCHES * n_shards,
                                                   values=_clone(vals), opt_cfg=OPT)
        want = ref_fn(*ref_args)
        # the plain step's own conditioning: its gradients' change when every
        # param moves by a rounding-sized 1e-7 of itself
        gen = torch.Generator().manual_seed(0)
        nudged = dict(vals, params=tree_map(lambda t: t * (1 + 1e-7 * torch.randn(t.shape, generator=gen)),
                                            vals["params"]))
        ref_fn, ref_args, _, _ = dryrun.build_cell(cfg, shape, one, microbatches=MICROBATCHES * n_shards,
                                                   values=_clone(nudged), opt_cfg=OPT)
        # the first step's first moment is (1 - b1) times the (clipped) gradient
        grads = [tree_map(lambda m: m / (1 - OPT.b1), o[1].m) for o in (got, want, ref_fn(*ref_args))]
        errs = {"loss": _errors(got[2], want[2]), "grads": _errors(*grads[:2], floor=1e-30),
                "params": _errors(got[0], want[0])}
        return {"errors": errs, "calls": calls,
                "sensitivity": max(_errors(grads[2], grads[1], floor=1e-30).values())}
    else:
        b = batch // n_shards
        outs, caches = [], []
        for i in range(n_shards):
            vi = {"params": vals["params"], "batch": _rows(vals["batch"], i * b, (i + 1) * b, 0),
                  "cache": _rows(vals["cache"], i * b, (i + 1) * b, 1)}
            ref_fn, ref_args, _, _ = dryrun.build_cell(cfg, replace(shape, global_batch=b), one, values=vi)
            if kind == "decode":
                ref_args = ref_args[:3] + (pos[i * b:(i + 1) * b],)
            outs.append(ref_fn(*ref_args))
            caches.append(ref_args[1] if kind == "decode" else ref_args[2])
        want_logits = torch.cat([o[0] for o in outs], dim=0)
        want_cache = tree_map(lambda *ts: torch.cat(ts, dim=1), *caches)
        errs = {"logits": _errors(got[0], want_logits), "cache": _errors(cache_got, want_cache),
                "returned_cache": _errors(got[1], want_cache)}
    return {"errors": errs, "calls": calls}


def run_rank(rank: int, world: int, store: str, out_dir: str, names=tuple(CASES)) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        res = {}
        for name in names:
            try:
                res[name] = _run_case(name)
            except Exception as e:          # every rank raises alike; the next case goes on
                res[name] = {"error": f"{type(e).__name__}: {e}"[:2000]}
        if rank == 0:
            with open(os.path.join(out_dir, "results.json"), "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()

"""The rank side of ``tests/test_torch_dist_training.py``: what each of the
four ``gloo`` ranks runs, in a module that imports no JAX (every rank is a
spawned process, and imports this module by name).

``run_rank`` joins the group through a ``file://`` store (no port), reads
the JAX package's references and inputs from ``ref.npz`` / ``ref.json``
(written by the test's JAX subprocess), runs every case on the port, and
writes this rank's results to ``rank<r>.npz``.  The test process checks
them; nothing is compared here.

Convention for gradients across ranks (see ``models/moe.py``): on the
model axis the loss counts once and every rank's replicated leaves get the
full gradient; across the batch axis each rank's loss is its shard's, the
global loss their mean, and the gradients of replicated leaves are averaged
(a shard's input gradient is its rank's over the data axis's size).
"""
from __future__ import annotations

import json
import os
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.bridge import params_from_numpy
from repro_torch.common.util import tree_leaves_with_path, tree_map
from repro_torch.configs.base import get_smoke_config
from repro_torch.launch.mesh import device_mesh, make_debug_mesh, use_mesh
from repro_torch.models import moe
from repro_torch.models.model import build_model
from repro_torch.sharding.rules import distribute, param_shardings, path_to_str, rules_for
from repro_torch.sharding.zero1 import zero1_opt_shardings
from repro_torch.training.compress import EFState, compressed_psum, ef_init
from repro_torch.training.optim import AdamWConfig, AdamWState, adamw_init, adamw_update
from repro_torch.training.pipeline import pipeline_forward
from repro_torch.training.train_loop import make_loss_fn, value_and_grad

MOE_ARCHS = ("qwen3_moe_235b", "qwen2_moe_a2p7b")
CAPACITY_FACTORS = (8.0, 1.25, 0.5)
N_DATA = N_MODEL = 2


def subtree(ref: dict, prefix: str) -> dict:
    """The nested dict of the arrays stored under ``prefix/``."""
    tree: dict = {}
    for key, arr in ref.items():
        if key.startswith(prefix + "/"):
            node = tree
            *parts, last = key[len(prefix) + 1:].split("/")
            for part in parts:
                node = node.setdefault(part, {})
            node[last] = arr
    return tree


def flat(prefix: str, tree) -> dict:
    """``{prefix/slash path: numpy array}`` of a tree of tensors."""
    out = {}
    for path, leaf in tree_leaves_with_path(tree):
        t = leaf.detach().to_local() if hasattr(leaf, "to_local") else leaf.detach()
        out[f"{prefix}/{path_to_str(path)}" if path else prefix] = t.float().cpu().numpy()
    return out


def _compress(rank: int, ref: dict, res: dict) -> None:
    """Two steps of compressed_psum over the four ranks, each with its own
    grads (fp32 and bf16 leaves), the residual of step 0 fed to step 1."""
    ef = None
    for step in range(2):
        g = {k: torch.from_numpy(v[rank]) for k, v in subtree(ref, f"compress/{step}/g").items()}
        g["b"] = g["b"].to(torch.bfloat16)
        if ef is None:
            ef = ef_init(g)
        out, ef = compressed_psum(g, ef, None, dist.get_world_size())
        res.update(flat(f"compress/{step}/out", out))
        res.update(flat(f"compress/{step}/res", ef.residual))
        res[f"compress/{step}/b_dtype_bf16"] = np.array(out["b"].dtype == torch.bfloat16)


def _compress_single(rank: int, groups: list, res: dict) -> None:
    """The JAX package's three compress tests, on a one-rank group."""
    group = groups[rank]
    # error feedback: g == out + residual
    g = {"w": torch.tensor([0.001, 1.0, -0.3])}
    out, ef2 = compressed_psum(g, ef_init(g), group, 1)
    res["single/ef_gap"] = (g["w"] - (out["w"] + ef2.residual["w"])).abs().max().numpy()

    # convergence parity: SGD on a quadratic, plain and compressed
    target = torch.tensor([0.5, -1.5, 2.0, 0.01])
    w_plain, w_comp = torch.zeros(4), torch.zeros(4)
    ef = ef_init({"w": w_comp})
    for _ in range(80):
        w_plain = w_plain - 0.2 * (w_plain - target)
        o, ef = compressed_psum({"w": w_comp - target}, ef, group, 1)
        w_comp = w_comp - 0.2 * o["w"]
    res["single/w_plain"], res["single/w_comp"], res["single/target"] = (
        w_plain.numpy(), w_comp.numpy(), target.numpy())

    # the payload of the sum is the int8 code: record what all_reduce carries
    seen = []
    real = dist.all_reduce

    def record(t, *a, **kw):
        seen.append((t.dtype, t.clone()))
        return real(t, *a, **kw)

    dist.all_reduce = record
    try:
        compressed_psum({"w": torch.linspace(-3, 3, 101)}, ef_init({"w": torch.zeros(101)}), group, 1)
    finally:
        dist.all_reduce = real
    (amax_dtype, amax), (code_dtype, code) = seen
    res["single/amax_is_f32_scalar"] = np.array(amax_dtype == torch.float32 and amax.numel() == 1)
    res["single/code_int32"] = np.array(code_dtype == torch.int32)
    res["single/code"] = code.numpy()


def _pipeline(rank: int, ref: dict, res: dict) -> None:
    ws, x = torch.from_numpy(ref["pipe/ws"]), torch.from_numpy(ref["pipe/x"])

    def layer_fn(w, h):
        return torch.tanh(h @ w)

    res["pipe/out"] = pipeline_forward(layer_fn, ws[rank], x).numpy()
    # the gradient of sum(outputs) w.r.t. this stage's weight and x
    w, xg = ws[rank].clone().requires_grad_(True), x.clone().requires_grad_(True)
    out = pipeline_forward(layer_fn, w, xg)
    out.sum().backward()
    res["pipe/out_grad_on"], res["pipe/gw"], res["pipe/gx"] = out.detach().numpy(), w.grad.numpy(), xg.grad.numpy()
    try:
        pipeline_forward(layer_fn, ws[rank], x[:3])
        res["pipe/few_micro_raised"] = np.array(False)
    except ValueError:
        res["pipe/few_micro_raised"] = np.array(True)


def _local(mesh):
    return mesh.get_local_rank("data"), mesh.get_local_rank("model")


def _moe_layer(mesh, ref: dict, res: dict) -> None:
    """The EP layer on this rank's batch shard and experts: y, aux and the
    gradients of N_DATA * sum(y * y) + aux (the mean over the data ranks is
    the JAX loss sum(y * y) + aux over the whole batch)."""
    i, _ = _local(mesh)
    for arch in MOE_ARCHS:
        cfg = get_smoke_config(arch)
        cfg_s = replace(cfg, dtype="float32", moe_shardmap_dispatch=True)
        p = moe.shard_experts(params_from_numpy(subtree(ref, f"moe/{arch}/p"), "cpu"), mesh)
        x = torch.from_numpy(ref[f"moe/{arch}/x"])
        b = x.shape[0] // N_DATA
        for cf in CAPACITY_FACTORS:
            pl = tree_map(lambda t: t.detach().requires_grad_(True), p)
            xl = x[i * b:(i + 1) * b].clone().requires_grad_(True)
            with use_mesh(mesh):
                y, aux = moe.apply_moe(pl, xl, cfg_s, capacity_factor=cf)
            loss = N_DATA * torch.sum(y * y) + aux
            leaves = [t for _, t in tree_leaves_with_path(pl)]
            grads = torch.autograd.grad(loss, leaves + [xl])
            tag = f"moe/{arch}/cf{cf}"
            res[f"{tag}/y"], res[f"{tag}/aux"] = y.detach().numpy(), aux.detach().numpy()
            for (path, _), g in zip(tree_leaves_with_path(pl), grads):
                res[f"{tag}/gp/{path_to_str(path)}"] = g.numpy()
            res[f"{tag}/gx"] = grads[-1].numpy()


def _moe_model(mesh, ref: dict, res: dict) -> None:
    """qwen3 smoke's apply_train loss (lm_loss + aux) and gradients with
    moe_shardmap_dispatch on, this rank's batch shard and experts."""
    i, _ = _local(mesh)
    cfg = get_smoke_config("qwen3_moe_235b")
    cfg = replace(cfg, dtype="float32", moe_shardmap_dispatch=True)
    model = build_model(cfg)
    params = moe.shard_experts(params_from_numpy(subtree(ref, "model/params"), "cpu"), mesh)
    tokens = torch.from_numpy(ref["model/tokens"]).long()
    b = tokens.shape[0] // N_DATA
    with use_mesh(mesh):
        (loss, _), grads = value_and_grad(make_loss_fn(model), params, {"tokens": tokens[i * b:(i + 1) * b]})
    res["model/loss"] = loss.detach().numpy()
    res.update(flat("model/grads", grads))
    # without a mesh the expert-parallel dispatch raises
    try:
        model.apply_train(params, {"tokens": tokens[:b]})
        res["model/no_mesh_raised"] = np.array(False)
    except RuntimeError:
        res["model/no_mesh_raised"] = np.array(True)


def _placement(mesh, ref: dict, res: dict) -> dict:
    """The smoke tree placed by the rules: each local shard, and the full
    tensors gathered back."""
    cfg = get_smoke_config("qwen3_moe_235b")
    cfg = replace(cfg, dtype="float32")
    params = params_from_numpy(subtree(ref, "model/params"), "cpu")
    sh = param_shardings(params, mesh, rules_for(cfg, mesh))
    placed = distribute(params, sh, mesh)
    res.update(flat("place/local", placed))
    gap = max(float((leaf.full_tensor() - full).abs().max()) if leaf.numel() else 0.0
              for (_, leaf), (_, full) in zip(tree_leaves_with_path(placed), tree_leaves_with_path(params)))
    res["place/full_gap"] = np.array(gap)
    for path, s in tree_leaves_with_path(sh):
        res[f"place/spec/{path_to_str(path)}"] = np.array(json.dumps(_spec_json(s.spec)))
    return sh


def _spec_json(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _zero1(mesh, ref: dict, res: dict, sh) -> None:
    """Two AdamW steps with params and grads placed by the rules and the
    moments by zero1_opt_shardings, beside the same steps unsharded; and one
    step with grads whose norm engages the clip."""
    cfg = AdamWConfig()
    params = params_from_numpy(subtree(ref, "model/params"), "cpu")
    state = adamw_init(params)
    zsh = zero1_opt_shardings(state, sh, mesh)
    for case, steps in (("small", ("g1", "g2")), ("clipped", ("g_big",))):
        p_plain, s_plain = params, state
        p_dist = distribute(params, sh, mesh)
        s_dist = AdamWState(state.count, distribute(state.m, zsh.m, mesh), distribute(state.v, zsh.v, mesh))
        for name in steps:
            g = params_from_numpy(subtree(ref, f"zero1/{name}"), "cpu")
            p_plain, s_plain, _ = adamw_update(g, s_plain, p_plain, cfg)
            p_dist, s_dist, _ = adamw_update(distribute(g, sh, mesh), s_dist, p_dist, cfg)
            p_dist = distribute(p_dist, sh, mesh)       # the ZeRO-1 gather of the params
            s_dist = AdamWState(s_dist.count, distribute(s_dist.m, zsh.m, mesh),
                                distribute(s_dist.v, zsh.v, mesh))
        res.update(flat(f"zero1/{case}/plain/p", p_plain))
        res.update(flat(f"zero1/{case}/plain/m", s_plain.m))
        res.update(flat(f"zero1/{case}/plain/v", s_plain.v))
        full = tree_map(lambda t: t.full_tensor(), {"p": p_dist, "m": s_dist.m, "v": s_dist.v})
        res.update(flat(f"zero1/{case}/dist", full))
        res.update(flat(f"zero1/{case}/local_m", s_dist.m))
        res[f"zero1/{case}/count"] = np.array(int(s_dist.count))
    for path, s in tree_leaves_with_path(zsh.m):
        res[f"zero1/spec/{path_to_str(path)}"] = np.array(json.dumps(_spec_json(s.spec)))


def run_rank(rank: int, world: int, store: str, ref_dir: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        ref = dict(np.load(os.path.join(ref_dir, "ref.npz")))
        res: dict = {}
        _compress(rank, ref, res)
        groups = [dist.new_group([r]) for r in range(world)]    # every rank creates every group
        _compress_single(rank, groups, res)
        _pipeline(rank, ref, res)
        mesh = device_mesh(make_debug_mesh(N_DATA, N_MODEL), "cpu")
        res["coord"] = np.array(_local(mesh))
        _moe_layer(mesh, ref, res)
        _moe_model(mesh, ref, res)
        sh = _placement(mesh, ref, res)
        _zero1(mesh, ref, res, sh)
        np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()

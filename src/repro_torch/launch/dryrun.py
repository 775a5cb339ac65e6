"""Dry run of the production meshes without their hardware (the port of
``repro/launch/dryrun.py``): every (arch x shape x mesh) cell's step is
traced on fake tensors, one rank's view of a 256-rank (16 x 16) or 512-rank
(2 x 16 x 16) mesh, and its memory, FLOPs, bytes, collectives and roofline
recorded.  No card, no weights, nothing allocated: the JAX package does the
same over ``ShapeDtypeStruct``s and forced host devices.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen1_5_110b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all            # one subprocess per cell
    python -m repro_torch.launch.dryrun --all --mesh multi --jobs 4   # four cells at once

Records append to ``build/dryrun/dryrun.json`` (or ``--out``), one per
(arch, shape, mesh, variant), a later record replacing an earlier one.

Two halves:

* hardware-free: ``_count_params``, ``_active_param_count`` and
  ``_useful_bytes_per_device`` on a ``device="meta"`` tree, and
  ``per_device_bytes``, each device's bytes of params, ZeRO-1 AdamW state,
  batch and cache from the shard shapes the sharding rules give on a
  ``launch.mesh.Mesh`` (no process group).
* the step: ``build_cell`` / ``run_cell``.  A fake process group (one
  process standing for every rank) carries a ``DeviceMesh`` of the
  production mesh; params, optimizer state, batch and cache are DTensors
  whose local shards are fake tensors, placed by ``sharding/rules.py`` and
  ``sharding/zero1.py``.  One train step (``make_train_step`` with AdamW and
  ``microbatches``-way accumulation, the params gathered back to their
  layout as JAX's ``out_shardings`` do), one prefill or one decode step
  runs under ``hwmodel.op_analysis.OpAnalysis``, which counts each op on
  rank 0's local shards, and ``MemTracker``, which gives the temp peak.
  The model's plain constants (masks, positions) join DTensor programs
  under ``implicit_replication``, and the ops DTensor's rules cannot run
  as written take their forms of ``sharding.dtensor_forms`` for the trace
  (attention, the WKV, the MoE region and the LM loss rank by rank through
  ``local_map``; the residual stream's layout between blocks, which the
  ``sequence_parallel`` variant shards to (batch, model)).

A train cell traces the config's ``remat_policy`` ("full" in every
config, as in the JAX dry run): the backward runs each layer's forward
again, and the op analysis and the memory tracker count it.

The MoE region routes each rank's batch shard on its own, capacity from
the local token count: the JAX package's ``shard_map`` dispatch, in every
MoE cell.  JAX's baseline routes the global batch in one program that XLA
partitions, which has no counterpart here.  So the variants whose flags
change nothing in this trace are refused (``INERT_FLAGS``):
``moe_shardmap_dispatch``, which is what every cell traces already, and
``moe_buffer_sharded``, a JAX layout choice, in every cell;
``hybrid_grouped`` in prefill and decode, where the loop is the same,
while in a train cell it changes the remat regions.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Iterator, Tuple

import torch

from repro_torch.common.util import tree_leaves_with_path, tree_map, tree_size_bytes
from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPES_BY_NAME,
    ModelConfig,
    ShapeConfig,
    get_config,
    shape_applicable,
)
from repro_torch.data.synthetic import make_batch_specs
from repro_torch.hwmodel.op_analysis import OpAnalysis, local_bytes, local_leaves, local_mem_tracker
from repro_torch.hwmodel.roofline import H100_SXM, collective_bytes, model_flops, roofline_report
from repro_torch.launch.mesh import Mesh, MeshLike, axis_sizes, make_production_mesh
from repro_torch.models.model import build_model, init_params
from repro_torch.sharding import dtensor_forms
from repro_torch.sharding.rules import batch_shardings, cache_shardings, param_shardings, rules_for, sharding_for
from repro_torch.sharding.zero1 import zero1_opt_shardings
from repro_torch.training.optim import AdamWConfig, AdamWState, adamw_init

ROOT = Path(__file__).resolve().parents[3]
RESULTS_PATH = ROOT / "build" / "dryrun" / "dryrun.json"


# ---------------------------------------------------------------------------
# The hardware-free half
# ---------------------------------------------------------------------------


def _count_params(tree) -> int:
    return int(sum(math.prod(leaf.shape) for _, leaf in tree_leaves_with_path(tree) if hasattr(leaf, "shape")))


def _active_param_count(cfg: ModelConfig, params_abs) -> int:
    """Exact param count scaled for MoE activation (top_k/n_experts on expert
    leaves) — the N in 6ND."""
    total = 0
    for pstr, leaf in tree_leaves_with_path(params_abs):
        if not hasattr(leaf, "shape"):
            continue
        n = int(math.prod(leaf.shape))
        if "embed" in pstr and "proj" not in pstr:
            continue  # embeddings excluded from 6ND (lookup, not matmul)
        if cfg.family == "moe" and "/moe'" in pstr.replace('"', "'") or (
            cfg.family == "moe" and "moe" in pstr and "w_" in pstr and "shared" not in pstr
        ):
            n = int(n * cfg.top_k / max(cfg.n_experts, 1))
        if cfg.shared_layers and "'layer'" in pstr:
            n = n * cfg.n_layers
        total += n
    return total


def _useful_bytes_per_device(cfg, shape, params_abs, n_chips: int) -> float:
    """Minimum mandatory HBM traffic per device per step: every resident
    param shard read once (+written once with moments for train: x4 for
    bf16 p+g and fp32 m+v r/w approximation), plus decode KV/state I/O."""
    params_bytes = tree_size_bytes(params_abs) / n_chips
    if shape.kind == "train":
        # read p, write p, read+write m,v (fp32 = 2x bf16), read g
        useful = params_bytes * (1 + 1 + 1 + 4 * 2)
    elif shape.kind == "prefill":
        tokens_local = shape.global_batch * shape.seq_len / n_chips
        act = tokens_local * cfg.d_model * 2 * cfg.n_layers  # one r/w per layer
        useful = params_bytes + act
    else:  # decode: params + full KV/state read + one-column write
        kv_b = 1 if cfg.kv_cache_dtype == "af8" else 2
        if cfg.family in ("dense", "moe", "vlm", "encdec"):
            kv = (
                2 * cfg.n_layers * shape.global_batch * shape.seq_len
                * cfg.n_kv_heads * cfg.head_dim * kv_b
            ) / n_chips
        elif cfg.family == "hybrid":
            n_attn = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
            kv = (
                2 * n_attn * shape.global_batch * shape.seq_len
                * cfg.n_kv_heads * cfg.head_dim * kv_b
            ) / n_chips
            kv += (
                cfg.n_layers * shape.global_batch
                * (2 * cfg.d_model // cfg.ssm_head_dim) * cfg.ssm_head_dim
                * cfg.ssm_state * 2 * 2
            ) / n_chips
        else:  # ssm
            kv = (
                cfg.n_layers * shape.global_batch * cfg.n_heads
                * cfg.head_dim * cfg.head_dim * 4 * 2
            ) / n_chips
        useful = params_bytes + kv
    return float(useful)


def shard_shape(shape, spec, mesh: MeshLike) -> Tuple[int, ...]:
    """One device's block of a leaf laid out by ``spec`` (``NamedSharding.shard_shape``)."""
    sizes = axis_sizes(mesh)
    out = []
    for d, dim in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
        n = math.prod(sizes[a] for a in axes)
        if dim % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide over {axes} ({n})")
        out.append(dim // n)
    return tuple(out)


def _local_tree_bytes(tree, shardings, mesh: MeshLike) -> int:
    return sum(math.prod(shard_shape(leaf.shape, sh.spec, mesh)) * leaf.dtype.itemsize
               for (_, leaf), (_, sh) in zip(tree_leaves_with_path(tree), tree_leaves_with_path(shardings)))


def cell_trees(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshLike) -> Dict[str, Tuple[Any, Any]]:
    """``{"params" | "opt_state" | "batch" | "cache": (meta tree, Sharding
    tree)}`` of a cell: what its step takes, laid out as the dry run lays
    it out (ZeRO-1 state for train, the cache for prefill and decode)."""
    rules = rules_for(cfg, mesh, shape)
    params = init_params(cfg, device="meta")
    p_sh = param_shardings(params, mesh, rules)
    trees = {"params": (params, p_sh)}
    batch = make_batch_specs(cfg, shape)
    if shape.kind == "train":
        opt = adamw_init(params)
        trees["opt_state"] = (opt, zero1_opt_shardings(opt, p_sh, mesh))
    else:
        cache = build_model(cfg).init_cache(shape.global_batch, shape.seq_len, device="meta")
        trees["cache"] = (cache, cache_shardings(cache, mesh, rules, cfg))
    b_sh = batch_shardings(batch, mesh, rules)
    if shape.kind == "decode" and rules.mesh_axis("cache_batch") is None:
        # batch-1 long-context: tokens replicated, the KV sequence sharded instead
        b_sh = tree_map(lambda _: sharding_for((), mesh), b_sh)
    trees["batch"] = (batch, b_sh)
    return trees


def per_device_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshLike) -> Dict[str, int]:
    """Each device's bytes of the cell's params, ZeRO-1 AdamW state (train),
    batch and cache (prefill, decode), from the rules' shard shapes."""
    return {name: _local_tree_bytes(tree, sh, mesh) for name, (tree, sh) in cell_trees(cfg, shape, mesh).items()}


# ---------------------------------------------------------------------------
# The step on fake tensors
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_world(size: int) -> Iterator[None]:
    """A fake process group of ``size`` ranks in this one process (rank 0):
    collectives return at once, and a ``DeviceMesh`` of any shape can be
    built over it.  Refuses to replace a group the caller already has."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake_dtensors(tree, shardings, dmesh):
    """``tree`` (meta) as DTensors whose local shards are fake tensors of
    rank 0's shard shape; call inside ``FakeTensorMode``."""
    from torch.distributed.tensor import DTensor, Replicate

    def place(leaf, sh):
        placements = sh.placements if sh.placements is not None else (Replicate(),) * dmesh.ndim
        local = shard_shape(leaf.shape, sh.spec, dmesh) if sh.placements is not None else tuple(leaf.shape)
        return DTensor.from_local(torch.empty(local, dtype=leaf.dtype), dmesh, placements, run_check=False,
                                  shape=tuple(leaf.shape), stride=torch.empty(leaf.shape, device="meta").stride())

    return tree_map(place, tree, shardings)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, microbatches: int = 8, values=None,
               opt_cfg: AdamWConfig = AdamWConfig()):
    """``(step_fn, args, params_abs, n_tokens)`` for this cell's step: call
    inside a ``FakeTensorMode`` (and, for a mesh of more than one rank,
    inside ``fake_world(mesh.size)``).  On a mesh of one rank ``args`` are
    plain fake tensors of the whole shapes (the step at world 1); otherwise
    DTensors over a ``DeviceMesh`` of ``mesh``, placed by the rules.
    ``step_fn(*args)`` runs one train step (``microbatches``-way
    accumulation, AdamW by ``opt_cfg``), one prefill or one decode step.  ``values`` (real
    ``params``, ``batch`` and, for prefill and decode, ``cache`` trees)
    are placed in place of fake tensors, over the caller's process group:
    the same step on real numbers."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    from repro_torch.launch.mesh import device_mesh
    from repro_torch.sharding.rules import distribute
    from repro_torch.training.train_loop import make_train_step

    model = build_model(cfg)
    if values is not None and shape.kind == "train":
        values = dict(values, opt_state=adamw_init(values["params"]))
    if mesh.size == 1:
        dmesh = None
        trees = cell_trees(cfg, shape, mesh)
        placed = values if values is not None else {
            name: tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), tree) for name, (tree, _) in trees.items()}
    else:
        with unset_fake_temporarily():      # the mesh's rank map is real data
            dmesh = device_mesh(mesh, "cpu")
        trees = cell_trees(cfg, shape, dmesh)
        placed = {name: _fake_dtensors(tree, sh, dmesh) if values is None else distribute(values[name], sh, dmesh)
                  for name, (tree, sh) in trees.items()}
    params_abs, p_sh = trees["params"]
    params, batch = placed["params"], placed["batch"]

    if shape.kind == "train":
        step = make_train_step(model, opt_cfg, microbatches=microbatches)
        o_sh = trees["opt_state"][1]

        def train_step(params, opt_state, batch):
            params, opt_state, metrics = step(params, opt_state, batch)
            if dmesh is not None:
                # the ZeRO-1 gather: params and moments back to their own layouts
                opt_state = AdamWState(opt_state.count, distribute(opt_state.m, o_sh.m, dmesh),
                                       distribute(opt_state.v, o_sh.v, dmesh))
                params = distribute(params, p_sh, dmesh)
            return params, opt_state, metrics["loss"]

        opt = placed["opt_state"]
        args = (params, AdamWState(torch.zeros((), dtype=torch.int32), opt.m, opt.v), batch)
        return train_step, args, params_abs, shape.global_batch * shape.seq_len
    cache = placed["cache"]
    if shape.kind == "prefill":
        aux = {k: v for k, v in batch.items() if k != "tokens"}

        def prefill_fn(params, tokens, cache, aux):
            return model.prefill(params, tokens, cache, aux=aux or None)

        return prefill_fn, (params, batch["tokens"], cache, aux), params_abs, shape.global_batch * shape.seq_len

    def decode_fn(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos, per_lane=False)

    pos = torch.full((), shape.seq_len - 1, dtype=torch.int32)
    return decode_fn, (params, cache, batch["tokens"], pos), params_abs, shape.global_batch


VARIANT_FLAGS = {
    # beyond-paper optimization stacks for §Perf hillclimbing
    "fused": dict(fused_attention=True),
    "sp": dict(sequence_parallel=True),
    "fused+sp": dict(fused_attention=True, sequence_parallel=True),
    "af8kv": dict(kv_cache_dtype="af8"),
    "fused+af8kv": dict(fused_attention=True, kv_cache_dtype="af8"),
    "moegroup": dict(moe_grouped_dispatch=True),
    "fused+moegroup": dict(fused_attention=True, moe_grouped_dispatch=True),
    "moegroup2": dict(moe_grouped_dispatch=True, moe_buffer_sharded=True),
    "fused+moegroup2": dict(
        fused_attention=True, moe_grouped_dispatch=True, moe_buffer_sharded=True
    ),
    "moeshmap": dict(moe_shardmap_dispatch=True),
    "fused+moeshmap": dict(fused_attention=True, moe_shardmap_dispatch=True),
    "fused+sp+moegroup": dict(
        fused_attention=True, sequence_parallel=True, moe_grouped_dispatch=True
    ),
    "ssmrep": dict(ssm_replicated=True),
    "fused+ssmrep": dict(fused_attention=True, ssm_replicated=True),
    "hybridgroup": dict(hybrid_grouped=True),
    "fused+hybridgroup": dict(fused_attention=True, hybrid_grouped=True),
    "opt": dict(
        fused_attention=True, sequence_parallel=True,
        moe_grouped_dispatch=True,
    ),
}


# flags of VARIANT_FLAGS that change nothing in the port's trace of a step
# of these kinds (the module's docstring says why); a variant that sets one
# is refused for those kinds
INERT_FLAGS = {"moe_shardmap_dispatch": ("train", "prefill", "decode"),
               "moe_buffer_sharded": ("train", "prefill", "decode"),
               "hybrid_grouped": ("prefill", "decode")}


def _inert(variant: str, kind: str) -> list:
    return [f for f in VARIANT_FLAGS.get(variant, {}) if kind in INERT_FLAGS.get(f, ())]


TRACED_VARIANTS = ("baseline",) + tuple(v for v in VARIANT_FLAGS
                                        if any(not _inert(v, kind) for kind in ("train", "prefill", "decode")))


def variant_config(arch: str, variant: str, multi_pod: bool, kind: str = "train") -> ModelConfig:
    """``arch``'s config under ``variant`` for a step of ``kind``; a
    variant that is unknown or changes nothing in that step's trace
    raises ``ValueError``."""
    cfg = get_config(arch)
    inert = _inert(variant, kind)
    if variant not in TRACED_VARIANTS or inert:
        raise ValueError(f"variant {variant!r} is not traced by the port's dry run"
                         + (f" for {kind}: {', '.join(inert)} change(s) nothing in its trace" if inert
                            else ": unknown variant"))
    if variant != "baseline":
        over = dict(VARIANT_FLAGS[variant])
        if over.get("sequence_parallel"):
            over["sp_batch_axes"] = ("pod", "data") if multi_pod else ("data",)
        cfg = dataclasses.replace(cfg, **over)
    return cfg


@contextlib.contextmanager
def _strided_shard_math_on_host() -> Iterator[None]:
    """DTensor works out the shard sizes of a strided layout (a matmul that
    folds [B, S] sharded on both) by splitting an index tensor and reading it
    back; under the trace's ``FakeTensorMode`` that index tensor would be
    fake and the read-back fails.  Inside this context the index math runs
    on real host tensors, unseen by the op analysis and the memory
    tracker."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types

    strided = getattr(placement_types, "_StridedShard", None)
    orig = getattr(strided, "local_shard_size_and_offset", None)
    if orig is None:            # a torch without strided layouts: nothing to move
        yield
        return

    def on_host(self, *args, **kwargs):
        with unset_fake_temporarily(), OpAnalysis._silenced():
            return orig(self, *args, **kwargs)

    strided.local_shard_size_and_offset = on_host
    try:
        yield
    finally:
        strided.local_shard_size_and_offset = orig


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, microbatches: int = 8) -> Dict[str, Any]:
    """Build the cell's step and trace it on fake tensors under a fake
    group of ``mesh.size`` ranks: the record's measured part (memory, op
    costs, collectives, the roofline on ``H100_SXM``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    rec: Dict[str, Any] = {}
    world = fake_world(mesh.size) if mesh.size > 1 else contextlib.nullcontext()
    with world, FakeTensorMode(allow_non_fake_inputs=True), _strided_shard_math_on_host(), \
            dtensor_forms.installed(cfg):
        t0 = time.time()
        fn, args, params_abs, n_tokens = build_cell(cfg, shape, mesh, microbatches=microbatches)
        rec["build_s"] = round(time.time() - t0, 2)
        mem = local_mem_tracker()
        mem.track_external(*local_leaves(args))
        analysis = OpAnalysis()
        analysis.add_inputs(args)
        t0 = time.time()
        with implicit_replication(), mem, analysis, torch.no_grad() if shape.kind != "train" else \
                contextlib.nullcontext():
            out = fn(*args)
        rec["trace_s"] = round(time.time() - t0, 2)
        peak = sum(v.get("Total", 0) for v in mem.get_tracker_snapshot("peak").values())
        arg_bytes, out_bytes = local_bytes(args), local_bytes(out)
    costs = analysis.costs
    rec["memory_analysis"] = {
        "argument_size_in_bytes": int(arg_bytes),
        "output_size_in_bytes": int(out_bytes),
        "temp_size_in_bytes": int(max(peak - arg_bytes, 0)),
        "peak_tracked_bytes": int(peak),
    }
    rec["op_analysis"] = {
        "flops_per_device": costs.flops,
        "bytes_per_device": costs.bytes_io,
        "collective_bytes_per_device": costs.coll_bytes,
        "top_ops": costs.table(12),
        "flops_by_op": {op: v["flops"] for op, v in costs.ops.items() if v["flops"]},
    }
    coll = collective_bytes(costs.collectives)
    coll.update(n_while=costs.n_while, max_trip=costs.max_trip)
    rec["collectives"] = coll
    n_active = _active_param_count(cfg, params_abs)
    rec["n_params"] = _count_params(params_abs)
    rec["n_params_active"] = n_active
    rec["roofline"] = roofline_report(
        hlo_flops_per_device=costs.flops,
        hlo_bytes_per_device=costs.bytes_io,
        collective_bytes_per_device=costs.coll_bytes,
        n_chips=mesh.size,
        model_flops_global=model_flops(n_active, n_tokens, shape.kind),
        useful_bytes_per_device=_useful_bytes_per_device(cfg, shape, params_abs, mesh.size),
        chip=H100_SXM,
    )
    rec["roofline"]["chip"] = H100_SXM.name
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool, microbatches: int = 8,
             variant: str = "baseline") -> Dict[str, Any]:
    shape = SHAPES_BY_NAME[shape_name]
    cfg = variant_config(arch, variant, multi_pod, shape.kind)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "variant": variant,
        "time": time.time(),
    }
    if not shape_applicable(cfg, shape):
        rec["status"] = "skipped"
        rec["reason"] = (
            "long_500k reserved for sub-quadratic families (ssm/hybrid); "
            f"{cfg.family} is full-attention"
        )
        return rec
    rec.update(record_cell(cfg, shape, make_production_mesh(multi_pod=multi_pod), microbatches))
    return rec


def record_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, microbatches: int = 8) -> Dict[str, Any]:
    """A cell's record on any mesh and config (``run_cell`` gives the
    production meshes and the full configs): the per-device bytes, the
    traced step's costs and ``status: ok`` (an error raises)."""
    rec: Dict[str, Any] = {"n_chips": mesh.size,
                           "microbatches": microbatches if shape.kind == "train" else 1,
                           "per_device_bytes": per_device_bytes(cfg, shape, mesh)}
    rec.update(trace_cell(cfg, shape, mesh, microbatches=microbatches))
    rec["status"] = "ok"
    return rec


def append_result(rec: Dict[str, Any], path=RESULTS_PATH):
    import fcntl

    path = str(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    lock_path = path + ".lock"
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # concurrent sweeps are safe
        results = []
        if os.path.exists(path):
            with open(path) as f:
                results = json.load(f)
        # replace same-key record
        key = (rec["arch"], rec["shape"], rec["mesh"], rec.get("variant", "baseline"))
        results = [
            r for r in results
            if (r["arch"], r["shape"], r["mesh"], r.get("variant", "baseline")) != key
        ]
        results.append(rec)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(results, f, indent=1)
        os.replace(tmp, path)


def _failing_op(exc: BaseException) -> str:
    """The innermost frame of the port or torch that raised: where a cell
    that errors failed."""
    tb = traceback.extract_tb(exc.__traceback__)
    ours = [f for f in tb if "repro_torch" in f.filename]
    f = ours[-1] if ours else tb[-1]
    return f"{os.path.basename(f.filename)}:{f.lineno} {f.name}: {f.line}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default=None)
    ap.add_argument("--shape", choices=list(SHAPES_BY_NAME), default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--timeout", type=int, default=3000)
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--variant", default="baseline", choices=TRACED_VARIANTS)
    ap.add_argument("--out", default=str(RESULTS_PATH), help="the records' JSON file")
    ap.add_argument("--jobs", type=int, default=1, help="with --all: cells traced at once, one process each")
    args = ap.parse_args(argv)

    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)

    if args.all:
        from concurrent.futures import ThreadPoolExecutor

        def one(cell):
            arch, shape, mesh = cell
            cmd = [
                sys.executable, "-m", "repro_torch.launch.dryrun",
                "--arch", arch, "--shape", shape, "--mesh", mesh,
                "--microbatches", str(args.microbatches),
                "--variant", args.variant, "--out", args.out,
            ]
            try:
                r = subprocess.run(cmd, timeout=args.timeout, capture_output=args.jobs > 1, text=True)
                failed = r.returncode != 0
            except subprocess.TimeoutExpired:
                append_result({"arch": arch, "shape": shape, "mesh": mesh, "variant": args.variant,
                               "status": "error", "error": f"timed out after {args.timeout} s"}, args.out)
                failed = True
            print(f"=== {arch} x {shape} x {mesh}: {'FAILED' if failed else 'done'} ===", flush=True)
            return cell if failed else None

        cells = [(a, s, m) for a in ARCH_IDS for s, shape in SHAPES_BY_NAME.items() for m in meshes
                 if not _inert(args.variant, shape.kind)]
        with ThreadPoolExecutor(max_workers=max(args.jobs, 1)) as pool:
            failures = [c for c in pool.map(one, cells) if c is not None]
        print("FAILURES:", failures if failures else "none")
        sys.exit(1 if failures else 0)

    if not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    try:
        variant_config(args.arch, args.variant, False, SHAPES_BY_NAME[args.shape].kind)
    except ValueError as e:
        ap.error(str(e))
    for mesh in meshes:
        try:
            rec = run_cell(args.arch, args.shape, multi_pod=(mesh == "multi"),
                           microbatches=args.microbatches, variant=args.variant)
        except Exception as e:
            rec = {
                "arch": args.arch, "shape": args.shape, "mesh": mesh,
                "variant": args.variant,
                "status": "error", "error": f"{type(e).__name__}: {str(e)[:500]}",
                "failing_op": _failing_op(e),
                "traceback": traceback.format_exc()[-2000:],
            }
        append_result(rec, args.out)
        status = rec["status"]
        if status == "ok":
            rl = rec["roofline"]
            print(
                f"{args.arch} {args.shape} {mesh} [{args.variant}]: OK "
                f"trace={rec['trace_s']}s dominant={rl['dominant']} "
                f"t=({rl['t_compute_s']:.3e},{rl['t_memory_s']:.3e},{rl['t_collective_s']:.3e})s "
                f"useful={rl['useful_flops_ratio']:.2f} roofline={rl['roofline_fraction']:.3f}"
            )
        else:
            print(f"{args.arch} {args.shape} {mesh}: {status} {rec.get('reason', rec.get('error', ''))}")
            if status == "error":
                print(rec.get("failing_op", ""))
                print(rec.get("traceback", ""))
                sys.exit(1)


if __name__ == "__main__":
    main()

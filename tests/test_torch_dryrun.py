"""The port's dry run (``launch/dryrun.py``) against the JAX package's.

The hardware-free half: for every arch of ``ARCH_IDS``, every shape where
``shape_applicable`` holds and both production meshes, the parameter counts
(all and active), the useful bytes per device and every leaf's per-device
shard shape (params, ZeRO-1 AdamW moments, batch, cache) equal JAX's.  The
JAX side runs once, in a subprocess (``repro.launch.dryrun`` forces 512
host devices when it is imported, as ``tests/test_dryrun_small.py`` runs
it), on ``jax.eval_shape`` trees and ``NamedSharding.shard_shape``; the
port's on meta trees and ``launch.mesh.Mesh`` values.

The step: ``tests/test_dryrun_small.py``'s smoke cells on a fake (2, 2)
mesh (four ranks in this process): ``tiny_train`` (64 x 8, microbatches 2)
for deepseek_7b, qwen3_moe_235b and rwkv6_7b, ``tiny_decode`` (128 x 8)
for zamba2_1p2b.  Each gives a ``status: ok`` record whose per-device
FLOPs lie between 1/4 and 1/2 of those of the same step traced at world 1,
and deepseek-7b's attention FLOPs are exactly a quarter (the XLA numbers
cannot be matched, so JAX's are not compared).  A train cell traces the
config's ``remat_policy`` ("full" in the smoke configs, as in JAX): the
backward runs each layer's forward again, and at 8 layers of 256 tokens the
temp peak falls below the same cell's under "none".
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs.base import ARCH_IDS, SHAPES, ShapeConfig, get_config, get_smoke_config, shape_applicable
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, make_debug_mesh, make_production_mesh
from repro_torch.common.util import tree_leaves_with_path
from repro_torch.sharding.rules import path_to_str

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

JAX_HALF_A = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs.base import ARCH_IDS, SHAPES, get_config, shape_applicable
    from repro.data.synthetic import make_batch_specs
    from repro.launch import dryrun
    from repro.launch.mesh import make_production_mesh
    from repro.models.model import build_model
    from repro.sharding.rules import batch_shardings, cache_shardings, param_shardings, path_to_str, rules_for
    from repro.sharding.zero1 import zero1_opt_shardings
    from repro.training.optim import adamw_init

    def shards(tree, shardings):
        return {path_to_str(p): [list(s.shard_shape(l.shape)), int(np.dtype(l.dtype).itemsize)]
                for (p, l), (_, s) in zip(jax.tree_util.tree_leaves_with_path(tree),
                                          jax.tree_util.tree_leaves_with_path(shardings))}

    out = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        model = build_model(cfg)
        params = dryrun._abstract_params(model)
        opt = jax.eval_shape(adamw_init, params)
        rec = out[arch] = {"n_params": dryrun._count_params(params),
                           "n_params_active": dryrun._active_param_count(cfg, params), "cells": {}}
        caches = {}
        for mesh_name in ("single", "multi"):
            mesh = make_production_mesh(multi_pod=mesh_name == "multi")
            n_chips = int(np.prod(mesh.devices.shape))
            for shape in SHAPES:
                if not shape_applicable(cfg, shape):
                    continue
                rules = rules_for(cfg, mesh, shape)
                ps = param_shardings(params, mesh, rules)
                cell = {"useful": dryrun._useful_bytes_per_device(cfg, shape, params, n_chips),
                        "params": shards(params, ps)}
                if shape.kind == "train":
                    cell["opt_state"] = shards(opt.m, zero1_opt_shardings(opt, ps, mesh).m)
                    batch = make_batch_specs(cfg, shape)
                    cell["batch"] = shards(batch, batch_shardings(batch, mesh, rules))
                else:
                    key = (shape.global_batch, shape.seq_len)
                    if key not in caches:
                        caches[key] = jax.eval_shape(lambda: model.init_cache(*key))
                    cell["cache"] = shards(caches[key], cache_shardings(caches[key], mesh, rules, cfg))
                    if shape.kind == "prefill":
                        batch = make_batch_specs(cfg, shape)
                        cell["batch"] = shards(batch, batch_shardings(batch, mesh, rules))
                    else:
                        tokens = {"tokens": jax.ShapeDtypeStruct((shape.global_batch, 1), jnp.int32)}
                        tsh = batch_shardings(tokens, mesh, rules)
                        if rules.mesh_axis("cache_batch") is None:
                            tsh = {"tokens": NamedSharding(mesh, P())}
                        cell["batch"] = shards(tokens, tsh)
                rec["cells"][f"{shape.name}/{mesh_name}"] = cell
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
""")


@pytest.fixture(scope="module")
def jax_half_a(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_dryrun") / "half_a.json"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=512", PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", JAX_HALF_A, str(path)], capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, f"stderr:\n{r.stderr[-3000:]}"
    return json.loads(path.read_text())


_PARAMS: dict = {}


def _params(arch):
    if arch not in _PARAMS:
        _PARAMS[arch] = dryrun.init_params(get_config(arch), device="meta")
    return _PARAMS[arch]


CELLS = [(arch, shape.name, mesh) for arch in ARCH_IDS for shape in SHAPES
         if shape_applicable(get_config(arch), shape) for mesh in ("single", "multi")]


def _shards(tree, shardings, mesh):
    return {path_to_str(p): [list(dryrun.shard_shape(leaf.shape, sh.spec, mesh)), leaf.dtype.itemsize]
            for (p, leaf), (_, sh) in zip(tree_leaves_with_path(tree), tree_leaves_with_path(shardings))}


@pytest.mark.parametrize("arch,shape_name,mesh_name", CELLS)
def test_half_a_matches_jax(jax_half_a, arch, shape_name, mesh_name):
    """Counts exact, useful bytes within 1e-12 relative, every leaf's shard
    shape (and dtype size) equal, and ``per_device_bytes`` the sum of the
    JAX shards' bytes."""
    cfg, shape = get_config(arch), next(s for s in SHAPES if s.name == shape_name)
    mesh = make_production_mesh(multi_pod=mesh_name == "multi")
    want = jax_half_a[arch]
    params = _params(arch)
    assert dryrun._count_params(params) == want["n_params"]
    assert dryrun._active_param_count(cfg, params) == want["n_params_active"]
    cell = want["cells"][f"{shape_name}/{mesh_name}"]
    useful = dryrun._useful_bytes_per_device(cfg, shape, params, mesh.size)
    assert abs(useful - cell["useful"]) <= 1e-12 * abs(cell["useful"])
    trees = dryrun.cell_trees(cfg, shape, mesh)
    groups = {"params": trees["params"], "batch": trees["batch"]}
    if shape.kind == "train":
        opt, osh = trees["opt_state"]
        groups["opt_state"] = (opt.m, osh.m)
    else:
        groups["cache"] = trees["cache"]
    assert sorted(groups) == sorted(k for k in cell if k != "useful")
    per_device = dryrun.per_device_bytes(cfg, shape, mesh)
    for name, (tree, sh) in groups.items():
        got = _shards(tree, sh, mesh)
        assert got == cell[name], name
        want_bytes = sum(math.prod(s) * size for s, size in cell[name].values())
        # the ZeRO-1 state holds two moments (m, v) and the step count
        assert per_device[name] == (2 * want_bytes + 4 if name == "opt_state" else want_bytes), name


def test_half_a_covers_every_applicable_cell(jax_half_a):
    assert sorted(jax_half_a) == sorted(ARCH_IDS)
    assert sum(len(r["cells"]) for r in jax_half_a.values()) == len(CELLS)


# ---------------------------------------------------------------------------
# The step on a fake (2, 2) mesh
# ---------------------------------------------------------------------------

SMOKE = [("deepseek_7b", "train"), ("qwen3_moe_235b", "train"), ("rwkv6_7b", "train"), ("zamba2_1p2b", "decode")]


@pytest.mark.parametrize("arch,kind", SMOKE)
def test_smoke_cell_on_a_fake_2x2_mesh(arch, kind):
    cfg = get_smoke_config(arch)
    shape = ShapeConfig("tiny_train", 64, 8, "train") if kind == "train" else ShapeConfig("tiny_decode", 128, 8,
                                                                                          "decode")
    rec = dryrun.record_cell(cfg, shape, make_debug_mesh(2, 2), microbatches=2)
    one = dryrun.record_cell(cfg, shape, Mesh(("data", "model"), (1, 1)), microbatches=2)
    assert rec["status"] == "ok" and rec["n_chips"] == 4
    flops, flops_1 = rec["op_analysis"]["flops_per_device"], one["op_analysis"]["flops_per_device"]
    # every matmul's work is per token or per sequence, and the data axis
    # halves both: FLOPs counted on the global shapes would give flops_1
    assert flops > 0 and flops_1 / 4 <= flops <= flops_1 / 2
    if arch == "deepseek_7b":
        # attention's batched matmuls: each rank holds half the sequences
        # and half the heads (8 KV heads on 2 model ranks)
        bmm, bmm_1 = rec["op_analysis"]["flops_by_op"]["bmm"], one["op_analysis"]["flops_by_op"]["bmm"]
        S, H, hd, L, B = shape.seq_len, cfg.n_heads, cfg.head_dim, cfg.n_layers, shape.global_batch
        # Q K^T and P V: the forward, its second run in the backward under
        # the smoke config's remat_policy "full", and the two products of
        # each backward
        assert cfg.remat_policy == "full"
        assert bmm_1 == 4 * 2 * (2 * S * S * hd * H) * L * B
        assert bmm == bmm_1 / 4
    assert rec["op_analysis"]["bytes_per_device"] > 0 and rec["collectives"]["bytes_total"] > 0
    assert one["collectives"]["bytes_total"] == 0
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] > 0 and mem["peak_tracked_bytes"] >= mem["argument_size_in_bytes"]
    assert rec["roofline"]["chip"] == "h100_sxm" and rec["roofline"]["n_chips"] == 4
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["n_params"] == dryrun._count_params(dryrun.init_params(cfg, device="meta"))


def test_variants_that_change_nothing_in_the_trace_are_refused():
    """Every MoE cell routes each rank's batch shard on its own (JAX's
    shard_map dispatch), so ``moeshmap`` would repeat the baseline, and
    ``moe_buffer_sharded`` is a JAX layout choice with no counterpart in
    the trace: refused for every step.  ``hybrid_grouped`` changes the
    remat regions of a train step and nothing of a prefill or decode step:
    refused for those."""
    refused = {v for v in dryrun.VARIANT_FLAGS if v not in dryrun.TRACED_VARIANTS}
    assert refused == {"moegroup2", "fused+moegroup2", "moeshmap", "fused+moeshmap"}
    with pytest.raises(ValueError, match="moe_shardmap_dispatch"):
        dryrun.run_cell("qwen3_moe_235b", "decode_32k", multi_pod=False, variant="moeshmap")
    with pytest.raises(ValueError, match="moe_shardmap_dispatch"):
        dryrun.variant_config("qwen3_moe_235b", "moeshmap", False, "train")
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "zamba2_1p2b", "--shape", "decode_32k", "--variant", "hybridgroup"])
    for kind in ("prefill", "decode"):
        with pytest.raises(ValueError, match=f"for {kind}: hybrid_grouped"):
            dryrun.variant_config("zamba2_1p2b", "fused+hybridgroup", False, kind)
    assert dryrun.variant_config("zamba2_1p2b", "hybridgroup", False, "train").hybrid_grouped
    assert dryrun.variant_config("qwen3_moe_235b", "moegroup", False).moe_grouped_dispatch


def test_hybridgroup_changes_a_train_cell_by_its_remat_regions():
    """zamba2's smoke train cell at world 1: with remat off the grouped and
    the per-block forms trace the same step; under "full" the regions
    differ (a group of blocks with the shared block, or one block each), and
    so does what the backward recomputes."""
    shape, mesh = ShapeConfig("tiny_train", 64, 4, "train"), Mesh(("data", "model"), (1, 1))
    recs = {(policy, grouped): dryrun.record_cell(
                dataclasses.replace(get_smoke_config("zamba2_1p2b"), remat_policy=policy, hybrid_grouped=grouped),
                shape, mesh, microbatches=1)
            for policy in ("none", "full") for grouped in (False, True)}
    flops = {k: r["op_analysis"]["flops_per_device"] for k, r in recs.items()}
    assert flops[("none", False)] == flops[("none", True)]
    assert flops[("full", False)] != flops[("full", True)]
    assert min(flops[("full", False)], flops[("full", True)]) > flops[("none", False)]


def test_a_smoke_train_cell_keeps_less_under_full_remat():
    """deepseek-7b's smoke config at 8 layers, 8 x 256 tokens, on the fake
    (2, 2) mesh: the temp peak under "full" is below the same cell's under
    "none", and the backward's second forward adds FLOPs."""
    shape = ShapeConfig("tiny_train", 256, 8, "train")
    recs = {policy: dryrun.record_cell(dataclasses.replace(get_smoke_config("deepseek_7b"), n_layers=8,
                                                           remat_policy=policy),
                                       shape, make_debug_mesh(2, 2), microbatches=2)
            for policy in ("none", "full")}
    assert all(r["status"] == "ok" for r in recs.values())
    temp = {p: r["memory_analysis"]["temp_size_in_bytes"] for p, r in recs.items()}
    assert temp["full"] < temp["none"], temp
    assert recs["full"]["op_analysis"]["flops_per_device"] > recs["none"]["op_analysis"]["flops_per_device"]


def test_cpu_mesh_all_to_all_is_named_as_such():
    """On a "cpu" mesh DTensor runs a Shard -> Shard move as an all-gather
    and a chunk; the record names it as the all-to-all it stands for."""
    cfg = get_smoke_config("zamba2_1p2b")
    rec = dryrun.record_cell(cfg, ShapeConfig("tiny_decode", 128, 8, "decode"), make_debug_mesh(2, 2))
    assert rec["collectives"]["count_all-to-all"] > 0
    assert any(r["op"] == "_dtensor.shard_dim_alltoall" for r in rec["op_analysis"]["top_ops"])


def test_cli_writes_and_replaces_records(tmp_path):
    """One production cell (deepseek-7b decode_32k on the 16 x 16 mesh)
    through the CLI, then a skipped one; a second run replaces the first
    record instead of adding one."""
    out = tmp_path / "dryrun.json"
    args = ["--arch", "deepseek_7b", "--shape", "decode_32k", "--out", str(out)]
    dryrun.main(args)
    dryrun.main(["--arch", "deepseek_7b", "--shape", "long_500k", "--out", str(out)])
    recs = json.loads(out.read_text())
    assert [(r["shape"], r["status"]) for r in recs] == [("decode_32k", "ok"), ("long_500k", "skipped")]
    rec = recs[0]
    assert rec["n_chips"] == 256 and rec["roofline"]["chip"] == "h100_sxm"
    assert set(rec["memory_analysis"]) >= {"argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes"}
    assert rec["per_device_bytes"] == dryrun.per_device_bytes(get_config("deepseek_7b"),
                                                              dryrun.SHAPES_BY_NAME["decode_32k"],
                                                              make_production_mesh())
    dryrun.append_result(dict(rec, status="ok", marker=1), out)
    recs = json.loads(out.read_text())
    assert len(recs) == 2 and recs[-1]["marker"] == 1


def test_fake_world_refuses_an_existing_group():
    import torch.distributed as dist

    with dryrun.fake_world(4):
        assert dist.get_world_size() == 4
        with pytest.raises(RuntimeError, match="already initialised"):
            with dryrun.fake_world(2):
                pass
    assert not dist.is_initialized()


def test_make_batch_specs_shapes_and_dtypes():
    """The JAX package's shapes and dtypes, on the meta device."""
    from repro_torch.data.synthetic import make_batch_specs

    train = ShapeConfig("t", 16, 4, "train")
    got = make_batch_specs(get_smoke_config("whisper_medium"), train)
    cfg = get_smoke_config("whisper_medium")
    assert {k: (tuple(v.shape), v.dtype, v.device.type) for k, v in got.items()} == {
        "tokens": ((4, 16), torch.int32, "meta"),
        "enc_input": ((4, cfg.enc_seq_len, cfg.d_model), getattr(torch, cfg.dtype), "meta")}
    vlm = get_smoke_config("llama3_2_vision_90b")
    assert tuple(make_batch_specs(vlm, train)["image_embeds"].shape) == (4, vlm.n_image_tokens, vlm.d_model)
    assert list(make_batch_specs(vlm, ShapeConfig("d", 16, 4, "decode"))) == ["tokens"]
    cls = get_smoke_config("albert_edgebert")
    assert tuple(make_batch_specs(cls, train)["labels"].shape) == (4,)
    assert "labels" not in make_batch_specs(cls, ShapeConfig("p", 16, 4, "prefill"))

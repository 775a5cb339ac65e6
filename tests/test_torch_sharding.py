"""The port's sharding rules, ZeRO-1 layouts and meshes against the JAX
package's, spec for spec.

The JAX side runs once, in one subprocess with 512 forced host devices (the
production meshes need them, as ``tests/test_dryrun_small.py`` forces
them), and writes every spec to JSON: ``param_shardings`` of every arch of
``ARCH_IDS`` at its full config (``jax.eval_shape``: nothing allocated) on
the (16, 16), (2, 16, 16) and (2, 4) meshes; ``batch_shardings`` and
``cache_shardings`` for each applicable shape; ``zero1_opt_shardings``; the
smoke-size cases of ``test_dryrun_small.py``.  The port computes the same
from ``Mesh`` values (no process group) and trees on the meta device, and
each check is a test of its own.  The DTensor placements of these specs
are held against JAX's device slices in ``test_torch_dist_training.py``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config, get_smoke_config, shape_applicable
from repro_torch.launch.mesh import Mesh, make_debug_mesh, make_production_mesh
from repro_torch.models.model import build_model, init_params
from repro_torch.sharding.rules import (
    batch_shardings,
    cache_shardings,
    logical_to_mesh,
    param_shardings,
    path_to_str,
    rules_for,
)
from repro_torch.sharding.zero1 import zero1_opt_shardings, zero1_param_sharding
from repro_torch.common.util import tree_leaves_with_path
from repro_torch.training.optim import adamw_init

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = {"16x16": ((16, 16), ("data", "model")), "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}

JAX_SPECS = textwrap.dedent("""
    import dataclasses, json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.common.jax_compat import make_auto_mesh
    from repro.configs.base import ARCH_IDS, SHAPES, get_config, get_smoke_config, shape_applicable
    from repro.data.synthetic import make_batch_specs
    from repro.launch.mesh import make_production_mesh
    from repro.models.model import build_model
    from repro.sharding.rules import batch_shardings, cache_shardings, param_shardings, path_to_str, rules_for
    from repro.sharding.zero1 import zero1_opt_shardings, zero1_param_sharding
    from repro.training.optim import adamw_init

    MESHES = json.loads(sys.argv[2])

    def spec_json(spec):
        return [list(e) if isinstance(e, tuple) else e for e in spec]

    def specs(tree, shardings):
        return {path_to_str(p): {"shape": list(l.shape), "spec": spec_json(s.spec)}
                for (p, l), (_, s) in zip(jax.tree_util.tree_leaves_with_path(tree),
                                          jax.tree_util.tree_leaves_with_path(shardings))}

    out = {"arch": {}}
    meshes = {name: make_auto_mesh(shape, axes) for name, (shape, axes) in MESHES.items()}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        model = build_model(cfg)
        params = jax.eval_shape(lambda: model.init_params(jax.random.PRNGKey(0)))
        opt = jax.eval_shape(adamw_init, params)
        caches = {}
        rec = out["arch"][arch] = {}
        for name, mesh in meshes.items():
            ps = param_shardings(params, mesh, rules_for(cfg, mesh))
            r = rec[name] = {"params": specs(params, ps),
                             "zero1": specs(opt.m, zero1_opt_shardings(opt, ps, mesh).m), "shapes": {}}
            for shape in SHAPES:
                if not shape_applicable(cfg, shape):
                    continue
                rules = rules_for(cfg, mesh, shape)
                batch = make_batch_specs(cfg, shape)
                s = r["shapes"][shape.name] = {"batch": specs(batch, batch_shardings(batch, mesh, rules))}
                if shape.kind in ("decode", "prefill"):
                    key = (shape.global_batch, shape.seq_len)
                    if key not in caches:
                        caches[key] = jax.eval_shape(lambda: model.init_cache(*key))
                    s["cache"] = specs(caches[key], cache_shardings(caches[key], mesh, rules, cfg))

    # the smoke cases of tests/test_dryrun_small.py on a (2, 4) mesh
    mesh = meshes["2x4"]
    for name, kw in (("rules", dict(d_ff=128, n_kv_heads=4)),
                     ("kv_fallback", dict(n_heads=12, n_kv_heads=3, head_dim=6, d_model=72, d_ff=128))):
        cfg = dataclasses.replace(get_smoke_config("qwen1_5_110b"), **kw)
        params = jax.eval_shape(lambda: build_model(cfg).init_params(jax.random.PRNGKey(0)))
        out[name] = specs(params, param_shardings(params, mesh, rules_for(cfg, mesh)))
    m42 = make_auto_mesh((4, 2), ("data", "model"))
    out["zero1_cases"] = [spec_json(zero1_param_sharding(jax.sharding.PartitionSpec(None, "model"), (128, 64), m42)),
                          spec_json(zero1_param_sharding(jax.sharding.PartitionSpec(None), (7,), m42))]
    out["production"] = {str(mp): [list(m.axis_names), list(m.devices.shape)]
                         for mp, m in ((False, make_production_mesh()), (True, make_production_mesh(multi_pod=True)))}
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
""")


@pytest.fixture(scope="module")
def jax_specs(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_specs") / "specs.json"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=512", PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", JAX_SPECS, str(path), json.dumps(MESHES)],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, f"stderr:\n{r.stderr[-3000:]}"
    return json.loads(path.read_text())


def _mesh(name: str) -> Mesh:
    shape, axes = MESHES[name]
    return Mesh(axes, shape)


def _specs(tree, shardings) -> dict:
    """``{slash path: {"shape", "spec"}}`` as the JAX side writes them."""
    return {path_to_str(p): {"shape": list(leaf.shape), "spec": [list(e) if isinstance(e, tuple) else e
                                                               for e in s.spec]}
            for (p, leaf), (_, s) in zip(tree_leaves_with_path(tree), tree_leaves_with_path(shardings))}


_TREES: dict = {}


def _params(arch: str):
    """The full config's tree on the meta device (shapes only), once per arch."""
    if arch not in _TREES:
        _TREES[arch] = init_params(get_config(arch), device="meta")
    return _TREES[arch]


CASES = [(arch, mesh) for arch in ARCH_IDS for mesh in MESHES]


@pytest.mark.parametrize("arch,mesh", CASES)
def test_param_specs_match_jax(jax_specs, arch, mesh):
    """Every leaf of the full config's tree: the same path, shape and spec."""
    cfg, m = get_config(arch), _mesh(mesh)
    params = _params(arch)
    got = _specs(params, param_shardings(params, m, rules_for(cfg, m)))
    assert got == jax_specs["arch"][arch][mesh]["params"]


@pytest.mark.parametrize("arch,mesh", CASES)
def test_zero1_specs_match_jax(jax_specs, arch, mesh):
    cfg, m = get_config(arch), _mesh(mesh)
    params = _params(arch)
    ps = param_shardings(params, m, rules_for(cfg, m))
    opt = adamw_init(params)
    assert _specs(opt.m, zero1_opt_shardings(opt, ps, m).m) == jax_specs["arch"][arch][mesh]["zero1"]


@pytest.mark.parametrize("arch,mesh", CASES)
def test_batch_and_cache_specs_match_jax(jax_specs, arch, mesh):
    """Each applicable shape's batch (the JAX dry run's batch shapes) and
    decode cache (the port's own init_cache on the meta device: the same
    paths and shapes as JAX's)."""
    cfg, m = get_config(arch), _mesh(mesh)
    want = jax_specs["arch"][arch][mesh]["shapes"]
    assert sorted(want) == sorted(s.name for s in SHAPES if shape_applicable(cfg, s))
    model = build_model(cfg)
    for shape in SHAPES:
        if not shape_applicable(cfg, shape):
            continue
        rules = rules_for(cfg, m, shape)
        batch = {k: torch.empty(v["shape"], device="meta") for k, v in want[shape.name]["batch"].items()}
        assert _specs(batch, batch_shardings(batch, m, rules)) == want[shape.name]["batch"], shape.name
        if shape.kind in ("decode", "prefill"):
            cache = model.init_cache(shape.global_batch, shape.seq_len, device="meta")
            assert _specs(cache, cache_shardings(cache, m, rules, cfg)) == want[shape.name]["cache"], shape.name


def test_param_sharding_rules_smoke(jax_specs):
    """``test_dryrun_small.py::test_param_sharding_rules``' case."""
    cfg = dataclasses.replace(get_smoke_config("qwen1_5_110b"), d_ff=128, n_kv_heads=4)
    m = make_debug_mesh(2, 4)
    params = init_params(cfg, device="meta")
    got = _specs(params, param_shardings(params, m, rules_for(cfg, m)))
    assert got == jax_specs["rules"]
    assert got["layers/attn/wq"]["spec"] == [None, None, "model"]
    assert got["layers/mlp/w_down"]["spec"] == [None, "model", None]
    assert got["embed/tok"]["spec"] == ["model", None]
    assert got["layers/norm1/scale"]["spec"] == []


def test_kv_indivisible_falls_back_replicated(jax_specs):
    """kv out dim 3 heads x 6 = 18 does not divide 4: replicated (wq's 72
    stays sharded), as ``test_dryrun_small.py:75``."""
    cfg = dataclasses.replace(get_smoke_config("qwen1_5_110b"), n_heads=12, n_kv_heads=3, head_dim=6,
                              d_model=72, d_ff=128)
    m = make_debug_mesh(2, 4)
    params = init_params(cfg, device="meta")
    got = _specs(params, param_shardings(params, m, rules_for(cfg, m)))
    assert got == jax_specs["kv_fallback"]
    assert got["layers/attn/wk"]["spec"] == [None, None, None]
    assert got["layers/attn/wq"]["spec"] == [None, None, "model"]


def test_zero1_shards_optimizer(jax_specs):
    """``test_dryrun_small.py:155``: data added on dim 0 beside model; an
    indivisible dim stays unsharded."""
    m = Mesh(("data", "model"), (4, 2))
    got = [zero1_param_sharding((None, "model"), (128, 64), m), zero1_param_sharding((None,), (7,), m)]
    assert got == [("data", "model"), (None,)]
    assert [list(g) for g in got] == jax_specs["zero1_cases"]


def test_production_mesh_shapes(jax_specs):
    """``test_dryrun_small.py:142``."""
    for multi_pod in (False, True):
        m = make_production_mesh(multi_pod=multi_pod)
        assert [list(m.axis_names), list(m.shape)] == jax_specs["production"][str(multi_pod)]
    assert make_production_mesh(multi_pod=True).size == 512


def test_logical_to_mesh():
    cfg = get_config("qwen2_moe_a2p7b")          # 60 experts: expert-TP on a 16-way model axis
    rules = rules_for(cfg, make_production_mesh())
    assert logical_to_mesh(rules, "experts", "moe_ffn", "batch", None) == (None, "model", "data", None)
    rules = rules_for(get_config("qwen3_moe_235b"), make_production_mesh(multi_pod=True))
    assert logical_to_mesh(rules, "experts", "moe_ffn", "batch") == ("model", None, ("pod", "data"))

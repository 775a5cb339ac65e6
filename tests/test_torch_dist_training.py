"""The training half of sharding in the port, held against the JAX package
on four ``gloo`` ranks: ``compressed_psum`` (int8 error-feedback
all-reduce), ``pipeline_forward`` (GPipe) and its gradient, ``apply_moe_shardmap``
(expert-parallel MoE) and its gradients, the sharding rules' DTensor
placement, and a ZeRO-1 AdamW step.

The JAX side runs once, in one subprocess with eight forced host devices
(as ``tests/test_dryrun_small.py`` runs it), and writes its inputs and
results to ``ref.npz`` / ``ref.json``.  The port side runs once, in one
4-rank ``torch.multiprocessing`` spawn (``tests/torch_dist_workers.py``:
a ``file://`` store under the test's tmp dir, so no port and nothing shared
between xdist workers), joined with a timeout of its own so that a hung
collective fails instead of eating the suite's time.  Each check below is
a test of its own that reads the stored results.
"""
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch.multiprocessing as mp

import torch_dist_workers as W

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RANKS = 4
SPAWN_TIMEOUT_S = 300
CLIP_NORM = W.AdamWConfig().grad_clip_norm

JAX_REFS = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.common.jax_compat import shard_map_norep
    from repro.configs.base import get_smoke_config
    from repro.launch.mesh import make_debug_mesh
    from repro.models import moe
    from repro.models.model import build_model
    from repro.sharding.rules import param_shardings, path_to_str, rules_for
    from repro.sharding.zero1 import zero1_opt_shardings
    from repro.training.compress import EFState, compressed_psum
    from repro.training.optim import AdamWConfig, adamw_init, adamw_update
    from repro.training.pipeline import pipeline_forward
    from repro.training.train_loop import make_loss_fn

    out_dir = sys.argv[1]
    arrs, meta = {}, {}

    def put(prefix, tree):
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            a = jnp.asarray(leaf)
            arrs[prefix + ("/" + path_to_str(path) if path else "")] = np.asarray(
                a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)

    def spec_json(spec):
        return [list(e) if isinstance(e, tuple) else e for e in spec]

    # compressed_psum: 4 ranks on a dp axis, each its own grads (rank r at
    # scale 0.1 (r + 1)), fp32 and bf16 leaves, two steps carrying residuals
    dp = Mesh(np.array(jax.devices()[:4]), ("dp",))
    rng = np.random.default_rng(0)
    shapes = {"a": ((37, 5), jnp.float32), "b": ((64,), jnp.bfloat16), "c": ((3, 4, 5), jnp.float32)}
    res = {k: jnp.zeros((4,) + s, jnp.float32) for k, (s, _) in shapes.items()}

    def body(g, r):
        o, ef = compressed_psum({k: v[0] for k, v in g.items()},
                                EFState({k: v[0] for k, v in r.items()}), "dp", 4)
        return {k: v[None] for k, v in o.items()}, {k: v[None] for k, v in ef.residual.items()}

    for step in range(2):
        g = {k: jnp.asarray(rng.standard_normal((4,) + s)
                            * (0.1 * (1 + np.arange(4))).reshape((4,) + (1,) * len(s)), dt)
             for k, (s, dt) in shapes.items()}
        # called as the JAX package's own tests call it, op by op (under
        # jit XLA contracts the residual's g32 - q * scale into a fused
        # multiply-add in its vector loops but not in their remainders)
        out, res = shard_map_norep(body, dp, (P("dp"), P("dp")), (P("dp"), P("dp")))(g, res)
        put(f"compress/{step}/g", g)
        put(f"compress/{step}/out", out)
        put(f"compress/{step}/res", res)

    # pipeline_forward: 4 stages, 8 microbatches of 2 x 16, linear + tanh
    st = Mesh(np.array(jax.devices()[:4]), ("stage",))
    ks = jax.random.split(jax.random.PRNGKey(0), 2)
    ws = jax.random.normal(ks[0], (4, 16, 16)) / np.sqrt(16)
    x = jax.random.normal(ks[1], (8, 2, 16))
    layer_fn = lambda w, h: jnp.tanh(h @ w)
    seq = x
    for s in range(4):
        seq = jax.vmap(lambda h: layer_fn(ws[s], h))(seq)
    put("pipe/ws", ws); put("pipe/x", x)
    put("pipe/out", jax.jit(lambda w, x: pipeline_forward(layer_fn, w, x, st))(ws, x)); put("pipe/seq", seq)
    # its gradient: loss = sum of the outputs, w.r.t. every stage's weight and x
    gw, gx = jax.jit(jax.grad(lambda w, x: jnp.sum(pipeline_forward(layer_fn, w, x, st)), argnums=(0, 1)))(ws, x)
    put("pipe/gw", gw); put("pipe/gx", gx)

    # apply_moe_shardmap on a 2 x 2 (data, model) mesh: y, aux and the
    # gradients of sum(y * y) + aux
    mesh = make_debug_mesh(2, 2)
    for arch in ("qwen3_moe_235b", "qwen2_moe_a2p7b"):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        cfg_s = dataclasses.replace(cfg, moe_shardmap_dispatch=True)
        p = moe.init_moe(jax.random.PRNGKey(0), cfg, jnp.float32)
        x = jax.random.normal(jax.random.PRNGKey(1), (4, 32, cfg.d_model)) * 0.5
        put(f"moe/{arch}/p", p); put(f"moe/{arch}/x", x)
        for cf in (8.0, 1.25, 0.5):
            def loss(p, x):
                y, aux = moe.apply_moe(p, x, cfg_s, capacity_factor=cf)
                return jnp.sum(y * y) + aux, (y, aux)
            with jax.set_mesh(mesh):
                (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(p, x)
            tag = f"moe/{arch}/cf{cf}"
            put(tag + "/y", y); put(tag + "/aux", aux); put(tag + "/gp", gp); put(tag + "/gx", gx)

    # the model: qwen3 smoke's loss and gradients through apply_train
    cfg = dataclasses.replace(get_smoke_config("qwen3_moe_235b"), dtype="float32")
    model = build_model(dataclasses.replace(cfg, moe_shardmap_dispatch=True))
    params = model.init_params(jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(2), (4, 32), 0, cfg.vocab_size)
    with jax.set_mesh(mesh):
        (loss, _), grads = jax.jit(jax.value_and_grad(make_loss_fn(model), has_aux=True))(params, {"tokens": tokens})
    put("model/params", params); put("model/tokens", tokens); put("model/loss", loss); put("model/grads", grads)

    # placement: the rules' specs and each mesh coordinate's slice
    sh = param_shardings(params, mesh, rules_for(cfg, mesh))
    place = {}
    for (path, leaf), (_, ns) in zip(jax.tree_util.tree_leaves_with_path(params),
                                     jax.tree_util.tree_leaves_with_path(sh)):
        imap = ns.devices_indices_map(leaf.shape)
        place[path_to_str(path)] = {
            "spec": spec_json(ns.spec),
            "slices": [[[s.start or 0, dim if s.stop is None else s.stop]
                        for s, dim in zip(imap[mesh.devices[i, j]], leaf.shape)]
                       for i in range(2) for j in range(2)]}
    meta["place"] = place

    # ZeRO-1: the moments' specs; two AdamW steps with grads below the clip,
    # and one with grads whose norm engages it
    opt = adamw_init(params)
    meta["zero1_specs"] = {path_to_str(path): spec_json(ns.spec) for path, ns in
                           jax.tree_util.tree_leaves_with_path(zero1_opt_shardings(opt, sh, mesh).m)}
    zg = {}
    leaves, treedef = jax.tree_util.tree_flatten(params)
    for n, (name, scale) in enumerate((("g1", 1e-4), ("g2", 1e-4), ("g_big", 1.0))):
        keys = jax.random.split(jax.random.PRNGKey(3 + n), len(leaves))
        zg[name] = jax.tree_util.tree_unflatten(
            treedef, [jax.random.normal(k, l.shape) * scale for k, l in zip(keys, leaves)])
        put(f"zero1/{name}", zg[name])
    acfg = AdamWConfig()
    update = jax.jit(lambda g, s, p: adamw_update(g, s, p, acfg))
    p1, s1, _ = update(zg["g1"], opt, params)
    p2, s2, m2 = update(zg["g2"], s1, p1)
    pb, sb, mb = update(zg["g_big"], opt, params)
    for case, (pp, ss, mm) in (("small", (p2, s2, m2)), ("clipped", (pb, sb, mb))):
        put(f"zero1/{case}/jax/p", pp); put(f"zero1/{case}/jax/m", ss.m); put(f"zero1/{case}/jax/v", ss.v)
        meta[f"zero1_{case}_grad_norm"] = float(mm["grad_norm"])
    np.savez(out_dir + "/ref.npz", **arrs)
    with open(out_dir + "/ref.json", "w") as f:
        json.dump(meta, f)
""")


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_refs")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8", PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", JAX_REFS, str(out)], capture_output=True, text=True,
                       timeout=SPAWN_TIMEOUT_S, env=env)
    assert r.returncode == 0, f"stderr:\n{r.stderr[-3000:]}"
    return out


@pytest.fixture(scope="module")
def ref(ref_dir):
    return dict(np.load(ref_dir / "ref.npz"))


@pytest.fixture(scope="module")
def meta(ref_dir):
    return json.loads((ref_dir / "ref.json").read_text())


@pytest.fixture(scope="module")
def ranks(ref_dir, tmp_path_factory):
    """The four ranks' results, [rank] -> {key: array}."""
    out = tmp_path_factory.mktemp("port_ranks")
    ctx = mp.start_processes(W.run_rank, args=(RANKS, str(out / "store"), str(ref_dir), str(out)),
                             nprocs=RANKS, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                pytest.fail(f"the {RANKS} ranks did not finish within {SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(RANKS)]


def _rel(a, b) -> float:
    """max |a - b| over the larger of the two's largest magnitude."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), np.abs(a).max(), 1e-30))


def _by_coord(ranks):
    """{(data, model): results} from each rank's mesh coordinate."""
    return {tuple(int(c) for c in r["coord"]): r for r in ranks}


# ---------------------------------------------------------------------------
# compressed_psum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("what", ["out", "res"])
def test_compressed_psum_bit_exact(ranks, ref, step, what):
    """Every rank's mean grads (fp32 and bf16 leaves) and new residuals
    equal the JAX shard_map's, bit for bit, at the first step and at the
    second, which carries the first step's residuals."""
    for r, res in enumerate(ranks):
        for leaf in ("a", "b", "c"):
            got, want = res[f"compress/{step}/{what}/{leaf}"], ref[f"compress/{step}/{what}/{leaf}"][r]
            np.testing.assert_array_equal(got, want, err_msg=f"rank {r} leaf {leaf}")
    assert all(bool(res[f"compress/{step}/b_dtype_bf16"]) for res in ranks)


def test_compressed_psum_error_feedback_accumulates(ranks):
    """g == out + residual (the JAX package's test, one rank)."""
    assert all(float(res["single/ef_gap"]) <= 1e-6 for res in ranks)


def test_compressed_psum_convergence_parity(ranks):
    """SGD with compressed grads reaches the optimum of the plain run."""
    for res in ranks:
        np.testing.assert_allclose(res["single/w_comp"], res["single/target"], atol=1e-2)
        np.testing.assert_allclose(res["single/w_comp"], res["single/w_plain"], atol=1e-2)


def test_compressed_psum_wire_payload_is_int8(ranks):
    """The summed payload is the int8 code widened to int32 (values in
    [-127, 127]); the only other collective is the scalar amax."""
    for res in ranks:
        assert bool(res["single/amax_is_f32_scalar"]) and bool(res["single/code_int32"])
        code = res["single/code"]
        assert code.min() >= -127 and code.max() <= 127 and code.max() == 127


# ---------------------------------------------------------------------------
# pipeline_forward
# ---------------------------------------------------------------------------


def test_pipeline_matches_jax_and_sequential(ranks, ref):
    """Every stage returns the last stage's outputs: within 1e-5 of the JAX
    pipeline's and of the sequential stack's."""
    for res in ranks:
        assert np.abs(res["pipe/out"] - ref["pipe/out"]).max() < 1e-5
        assert np.abs(res["pipe/out"] - ref["pipe/seq"]).max() < 1e-5


def test_pipeline_needs_n_stages_microbatches(ranks):
    assert all(bool(res["pipe/few_micro_raised"]) for res in ranks)


def test_pipeline_weight_gradients_match_jax(ranks, ref):
    """loss = sum of the outputs under autograd: each rank's stage weight
    gradient within 1e-5 of jax.grad of JAX's pipeline_forward for that
    stage, and the forward under autograd equal to the forward without it,
    bit for bit."""
    for r, res in enumerate(ranks):
        assert np.abs(res["pipe/gw"] - ref["pipe/gw"][r]).max() < 1e-5, r
        np.testing.assert_array_equal(res["pipe/out_grad_on"], res["pipe/out"])
    assert np.abs(ref["pipe/gw"]).max() > 0.1


def test_pipeline_input_gradient_on_every_rank_matches_jax(ranks, ref):
    """x is replicated, so JAX sums its per-device cotangents: every rank's
    x.grad is stage 0's, within 1e-5 of jax.grad's, and the ranks agree bit
    for bit."""
    for res in ranks:
        assert np.abs(res["pipe/gx"] - ref["pipe/gx"]).max() < 1e-5
        np.testing.assert_array_equal(res["pipe/gx"], ranks[0]["pipe/gx"])
    assert np.abs(ref["pipe/gx"]).max() > 0.1


# ---------------------------------------------------------------------------
# apply_moe_shardmap on the 2 x 2 (data, model) mesh
# ---------------------------------------------------------------------------

MOE_CASES = [(arch, cf) for arch in W.MOE_ARCHS for cf in W.CAPACITY_FACTORS]


def _moe_grads(by, tag, paths):
    """The port's global gradients from the ranks': replicated leaves
    averaged over the data axis (equal on the model axis), expert leaves
    those averages joined along the experts, x the data shards' each over
    the data axis's size."""
    out = {}
    for path in paths:
        per_model = []
        for j in range(W.N_MODEL):
            per_model.append(np.mean([by[(i, j)][f"{tag}/gp/{path}"] for i in range(W.N_DATA)], axis=0))
        expert = path.split("/")[-1] in ("w_gate", "w_up", "w_down") and "shared" not in path
        if expert:
            out[path] = np.concatenate(per_model, axis=0)
        else:
            for j in range(1, W.N_MODEL):
                np.testing.assert_allclose(per_model[j], per_model[0], rtol=0, atol=1e-6 * np.abs(per_model[0]).max())
            out[path] = per_model[0]
    out["x"] = np.concatenate([by[(i, 0)][f"{tag}/gx"] / W.N_DATA for i in range(W.N_DATA)], axis=0)
    return out


@pytest.mark.parametrize("arch,cf", MOE_CASES)
def test_moe_shardmap_outputs(ranks, ref, arch, cf):
    """y within 2e-5 of JAX's apply_moe_shardmap (the same on both model
    ranks of a data shard), aux equal to it on every rank."""
    by = _by_coord(ranks)
    tag = f"moe/{arch}/cf{cf}"
    y = np.concatenate([by[(i, 0)][f"{tag}/y"] for i in range(W.N_DATA)], axis=0)
    assert np.abs(y - ref[f"{tag}/y"]).max() < 2e-5
    for (i, j), res in by.items():
        np.testing.assert_array_equal(res[f"{tag}/y"], by[(i, 0)][f"{tag}/y"])
        np.testing.assert_allclose(res[f"{tag}/aux"], ref[f"{tag}/aux"], rtol=1e-6)


@pytest.mark.parametrize("arch,cf", MOE_CASES)
def test_moe_shardmap_gradients(ranks, ref, arch, cf):
    """Every gradient leaf of sum(y * y) + aux, and x's, within 1e-5 of the
    leaf's largest magnitude of jax.grad through the JAX dispatch."""
    by = _by_coord(ranks)
    tag = f"moe/{arch}/cf{cf}"
    paths = [k[len(f"{tag}/gp/"):] for k in ref if k.startswith(f"{tag}/gp/")]
    assert "router" in paths and ("shared/w_up" in paths) == (arch == "qwen2_moe_a2p7b")
    got = _moe_grads(by, tag, paths)
    for path in paths:
        assert _rel(got[path], ref[f"{tag}/gp/{path}"]) < 1e-5, path
    assert _rel(got["x"], ref[f"{tag}/gx"]) < 1e-5


def test_moe_shardmap_drops_tokens_at_low_capacity(ref):
    """Dropped assignments change a token's output from capacity 8's (where
    none drop): at capacity factor 1.25 qwen3's smoke layer drops some (2
    of 128 tokens change; qwen2-moe's, with 6 experts, none on this data);
    at 0.5 both drop many.  So the drop path is exercised and held against
    JAX's."""
    def tokens_changed(arch, cf):
        return int((np.abs(ref[f"moe/{arch}/cf{cf}/y"] - ref[f"moe/{arch}/cf8.0/y"]).max(-1) > 0).sum())

    assert tokens_changed("qwen3_moe_235b", 1.25) > 0
    assert all(tokens_changed(arch, 0.5) > 10 for arch in W.MOE_ARCHS)


def test_moe_model_loss_and_gradients(ranks, ref):
    """qwen3 smoke's apply_train with moe_shardmap_dispatch under the mesh:
    the loss (the mean of the data shards') and every gradient leaf within
    1e-5 of the leaf's largest magnitude of JAX's."""
    by = _by_coord(ranks)
    loss = np.mean([by[(i, 0)]["model/loss"] for i in range(W.N_DATA)])
    np.testing.assert_allclose(loss, ref["model/loss"], rtol=1e-6)
    paths = [k[len("model/grads/"):] for k in ref if k.startswith("model/grads/")]
    for path in paths:
        per_model = [np.mean([by[(i, j)][f"model/grads/{path}"] for i in range(W.N_DATA)], axis=0)
                     for j in range(W.N_MODEL)]
        expert = "moe/w_" in path
        got = np.concatenate(per_model, axis=1) if expert else per_model[0]
        assert _rel(got, ref[f"model/grads/{path}"]) < 1e-5, path


def test_moe_shardmap_raises_without_mesh(ranks):
    assert all(bool(res["model/no_mesh_raised"]) for res in ranks)


# ---------------------------------------------------------------------------
# Placement and ZeRO-1
# ---------------------------------------------------------------------------


def test_placement_local_shards_match_jax_slices(ranks, ref, meta):
    """Each rank's local shard of the smoke tree placed by the rules equals
    the slice JAX's NamedSharding gives the device at the same mesh
    coordinate; the specs are JAX's entry for entry."""
    by = _by_coord(ranks)
    place = meta["place"]
    assert any(any(e is not None for e in v["spec"]) for v in place.values())
    for path, want in place.items():
        full = ref[f"model/params/{path}"]
        for n, (i, j) in enumerate((i, j) for i in range(2) for j in range(2)):
            res = by[(i, j)]
            assert json.loads(str(res[f"place/spec/{path}"])) == want["spec"], path
            sl = tuple(slice(a, b) for a, b in want["slices"][n])
            np.testing.assert_array_equal(res[f"place/local/{path}"], full[sl], err_msg=path)


def test_placement_full_tensor_round_trip(ranks):
    assert all(float(res["place/full_gap"]) == 0.0 for res in ranks)


def test_zero1_specs_match_jax(ranks, meta):
    for res in ranks:
        for path, want in meta["zero1_specs"].items():
            assert json.loads(str(res[f"zero1/spec/{path}"])) == want, path


def test_zero1_step_bit_exact_below_clip(ranks, meta):
    """Two AdamW steps with grads below the clip norm: the params and
    moments from the sharded step equal the unsharded port's bit for bit."""
    assert meta["zero1_small_grad_norm"] < CLIP_NORM
    for res in ranks:
        for what in ("p", "m", "v"):
            keys = [k for k in res if k.startswith(f"zero1/small/plain/{what}/")]
            assert keys
            for k in keys:
                np.testing.assert_array_equal(res[k.replace("/plain/", "/dist/")], res[k], err_msg=k)


def test_zero1_step_clipped_within_ulps(ranks, meta):
    """One step with grads whose norm engages the clip: the clip scale is a
    float32 norm summed over shards in another order than the unsharded
    sum, so the params and moments agree to float32 rounding, not bit for
    bit."""
    assert meta["zero1_clipped_grad_norm"] > CLIP_NORM
    for res in ranks:
        for what in ("p", "m", "v"):
            for k in [k for k in res if k.startswith(f"zero1/clipped/plain/{what}/")]:
                np.testing.assert_allclose(res[k.replace("/plain/", "/dist/")], res[k], rtol=2e-6, atol=1e-12)


@pytest.mark.parametrize("case", ["small", "clipped"])
def test_zero1_step_matches_jax(ranks, ref, case):
    """The sharded step against JAX's adamw_update, within the training
    parity tolerance (1e-6 of each leaf's magnitude)."""
    for res in ranks:
        for what in ("p", "m", "v"):
            keys = [k for k in ref if k.startswith(f"zero1/{case}/jax/{what}/")]
            assert keys
            for k in keys:
                got = res[k.replace("/jax/", "/dist/")]
                assert _rel(got, ref[k]) < 1e-6, k


def test_zero1_moments_are_sharded_over_data(ranks, meta):
    """Each moment's local shard is 1 / dp of its ZeRO-1 dim (and 1 / m of a
    model-sharded dim)."""
    by = _by_coord(ranks)
    sizes = {"data": W.N_DATA, "model": W.N_MODEL}
    n_data_sharded = 0
    for path, spec in meta["zero1_specs"].items():
        full = by[(0, 0)][f"zero1/small/dist/m/{path}"].shape
        want = tuple(d // (sizes[e] if e else 1) for d, e in zip(full, spec + [None] * (len(full) - len(spec))))
        n_data_sharded += "data" in spec
        for res in ranks:
            assert res[f"zero1/small/local_m/{path}"].shape == want, path
    assert n_data_sharded > 0

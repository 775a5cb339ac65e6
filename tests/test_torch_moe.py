"""The MoE decoder family's model math, port against the JAX package.

Both MoE smoke configs in float32: ``qwen2_moe_a2p7b`` (2 layers, d_model
64, 4 x 16 heads, 6 experts top-2 with a shared expert, qkv biases, vocab
512) and ``qwen3_moe_235b`` (8 experts top-2, GQA 8 / 2, no shared expert,
no bias).  The JAX package initialises the params; its qkv biases start at
zero, so they are set to random nonzero values (numpy, seeded) before the
weight bridge carries the tree across.  Inputs come from numpy seeds.

Tolerances: ``apply_moe`` outputs within 1e-6 of their largest magnitude
(float32 sums in another order; the outputs reach ~9 here, where one
float32 ulp is ~1e-6, so an absolute 1e-6 would ask for the same bits), the
aux loss within 1e-6; logits, entropies and caches within 1e-5 as in
test_torch_decode.py; tokens, exit layers, accept masks and the dropped
(token, expert) pairs equal.

Capacity couples the tokens of one routing, so each comparison keeps the
JAX package's grouping: the port's decode methods route each lane alone
(against the JAX serving step's lane ``vmap``), or all lanes together with
``moe_per_lane=False`` (against the JAX model's batched call); prefill and
token exit route the whole batch together in both packages.  The lane
counts here (8 lanes at top-2 of 6 experts, capacity 4) are large enough
that routing the lanes together would drop assignments the reference
keeps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as j_smoke
from repro.kernels import dispatch as jdispatch
from repro.models import layers as JL
from repro.models import moe as jmoe
from repro.models.model import build_model as j_build
from repro.serving import step_math as jsm
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config as t_config
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.models import layers as TL
from repro_torch.models import moe as tmoe
from repro_torch.models.model import build_model as t_build
from repro_torch.models.model import init_params as t_init
from repro_torch.serving import step_math as tsm

ATOL = 1e-5
MOE_ATOL = 1e-6
ARCHS = ("qwen2_moe_a2p7b", "qwen3_moe_235b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module (see test_torch_decode.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    return tuple(dataclasses.replace(get(arch), dtype="float32", remat_policy="none", **kw)
                 for get in (j_smoke, t_smoke))


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


def _close_moe(got, want):
    """Within MOE_ATOL of the largest output magnitude."""
    want = np.asarray(want)
    _close(got, want, MOE_ATOL * max(1.0, float(np.abs(want).max())))


def _tcache(jcache):
    return {k: _t(v) for k, v in jcache.items()}


def _with_random_biases(jp, cfg, seed=0):
    """The JAX tree with random nonzero qkv biases (the JAX init zeroes
    them, which would leave the bias path untested)."""
    if not cfg.qkv_bias:
        return jp
    r = _rng(seed)
    attn = dict(jp["layers"]["attn"])
    for name in ("bq", "bk", "bv"):
        attn[name] = jnp.asarray((0.5 * r.standard_normal(attn[name].shape)).astype(np.float32))
    return dict(jp, layers=dict(jp["layers"], attn=attn))


_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        jcfg, tcfg = _cfgs(arch)
        jm, tm = j_build(jcfg), t_build(tcfg)
        jp = _with_random_biases(jm.init_params(jax.random.PRNGKey(1)), jcfg)
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        _MODELS[arch] = (jm, tm, jp, tp, jcfg)
    return _MODELS[arch]


@pytest.fixture(params=ARCHS)
def dec(request):
    return _model(request.param)


def _filled_jcache(cfg, B, S, seed):
    r = _rng(seed)
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
    return {k: jnp.asarray(r.standard_normal(shape).astype(np.float32)) for k in ("k", "v")}


def _moe_params(arch, layer=0):
    jm, tm, jp, tp, cfg = _model(arch)
    pj = jax.tree_util.tree_map(lambda a: a[layer], jp["layers"]["moe"])
    pt = jax.tree_util.tree_map(lambda a: a[layer], tp["layers"]["moe"])
    return pj, pt, cfg


def _j_dropped(p, x, cfg, capacity_factor, grouped):
    """The (group, token, expert) assignments the JAX package drops: its
    own routing ops (router softmax, ``lax.top_k``, the stable argsort, the
    capacity cut) as ``repro.models.moe._moe_tokens`` runs them."""
    groups = x if grouped else x.reshape(1, -1, x.shape[-1])
    E, k = cfg.n_experts, cfg.top_k
    out = set()
    for g, xt in enumerate(groups):
        N = xt.shape[0]
        probs = jax.nn.softmax(jnp.asarray(xt, jnp.float32) @ p["router"], axis=-1)
        _, expert_idx = jax.lax.top_k(probs, k)
        C = max(int(N * k * capacity_factor / E), 4)
        flat_expert = expert_idx.reshape(-1)
        flat_token = jnp.repeat(jnp.arange(N), k)
        order = jnp.argsort(flat_expert, stable=True)
        se, st = flat_expert[order], flat_token[order]
        counts = jnp.zeros((E,), jnp.int32).at[flat_expert].add(1)
        starts = jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(counts)[:-1]])
        pos = jnp.arange(N * k) - starts[se]
        for t, e, v in zip(np.asarray(st), np.asarray(se), np.asarray(pos < C)):
            if not v:
                out.add((g, int(t), int(e)))
    return out


def _t_dropped(p, x, cfg, capacity_factor, grouped):
    xt = _t(x) if grouped else _t(x).reshape(1, -1, x.shape[-1])
    r = tmoe.route(p, xt, cfg, capacity_factor)
    G, N, k = r.slot.shape
    drop = r.slot == cfg.n_experts * r.capacity
    return {(g, t, int(r.expert_idx[g, t, j])) for g in range(G) for t in range(N) for j in range(k)
            if drop[g, t, j]}


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("grouped", [False, True])
def test_apply_moe(arch, grouped):
    """Output and aux loss at the default capacity, flat and grouped."""
    pj, pt, cfg = _moe_params(arch)
    x = (0.5 * _rng(3).standard_normal((4, 8, cfg.d_model))).astype(np.float32)
    cfg_j, cfg_t = _cfgs(arch, moe_grouped_dispatch=grouped)
    y_j, aux_j = jmoe.apply_moe(pj, jnp.asarray(x), cfg_j)
    y_t, aux_t = tmoe.apply_moe(pt, _t(x), cfg_t)
    _close_moe(y_t, y_j)
    _close(aux_t, aux_j, MOE_ATOL)
    # the keyword overrides the config's grouping
    y_k, aux_k = tmoe.apply_moe(pt, _t(x), _cfgs(arch)[1], grouped=grouped)
    assert torch.equal(y_k, y_t) and torch.equal(aux_k, aux_t)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("grouped", [False, True])
def test_capacity_overflow_drops_the_same_assignments(arch, grouped):
    """At capacity factor 1.0 tokens overflow: the dropped (token, expert)
    pairs, from each package's own routing, are the same and not empty,
    and so are the outputs."""
    pj, pt, cfg = _moe_params(arch)
    r = _rng(4)
    x = (0.5 * r.standard_normal((2, 24, cfg.d_model))).astype(np.float32)
    x += 0.8 * r.standard_normal(cfg.d_model).astype(np.float32)     # a shared direction crowds experts
    want = _j_dropped(pj, x, cfg, 1.0, grouped)
    got = _t_dropped(pt, x, cfg, 1.0, grouped)
    assert want and got == want
    cfg_g = dataclasses.replace(cfg, moe_grouped_dispatch=grouped)
    y_j, aux_j = jmoe.apply_moe(pj, jnp.asarray(x), cfg_g, capacity_factor=1.0)
    y_t, aux_t = tmoe.apply_moe(pt, _t(x), cfg_g, capacity_factor=1.0)
    _close_moe(y_t, y_j)
    _close(aux_t, aux_j, MOE_ATOL)


def test_capacity_arithmetic():
    _, cfg = _cfgs("qwen2_moe_a2p7b")
    full = t_config("qwen2_moe_a2p7b")
    for n, cf in ((1, 1.25), (8, 1.25), (32, 1.0), (100, 1.25), (19, 8.0)):
        assert tmoe.capacity(n, cfg, cf) == max(int(n * cfg.top_k * cf / cfg.n_experts), 4)
    assert tmoe.capacity(8, cfg) == 4 and tmoe.capacity(4, full) == 4


def test_top_k_breaks_ties_toward_the_lower_expert():
    """Equal router probabilities: the stable descending sort picks the
    lower expert indices first, as jax.lax.top_k does."""
    _, cfg = _cfgs("qwen3_moe_235b")
    d, E = cfg.d_model, cfg.n_experts
    router = np.zeros((d, E), np.float32)
    router[0, [1, 3, 5]] = 1.0                   # experts 1, 3 and 5 tie on top
    x = np.zeros((1, 2, d), np.float32)
    x[0, :, 0] = 1.0
    _, want = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x[0]) @ jnp.asarray(router), axis=-1), cfg.top_k)
    r = tmoe.route({"router": _t(router)}, _t(x), cfg)
    np.testing.assert_array_equal(r.expert_idx[0].numpy(), np.asarray(want))
    assert r.expert_idx[0, 0].tolist() == [1, 3]


def test_grouped_moe_matches_flat():
    """The port of test_perf_features.py's case: with generous capacity no
    token drops in either scheme, so grouped equals flat; both against the
    JAX package's."""
    pj, pt, cfg = _moe_params("qwen3_moe_235b")
    x = (0.5 * _rng(5).standard_normal((4, 32, cfg.d_model))).astype(np.float32)
    y_flat, _ = tmoe.apply_moe(pt, _t(x), cfg, capacity_factor=8.0)
    cfg_g = dataclasses.replace(cfg, moe_grouped_dispatch=True)
    y_grp, _ = tmoe.apply_moe(pt, _t(x), cfg_g, capacity_factor=8.0)
    _close(y_flat, y_grp, 2e-5)
    _close_moe(y_grp, jmoe.apply_moe(pj, jnp.asarray(x), cfg_g, capacity_factor=8.0)[0])


def test_apply_moe_shardmap_raises():
    _, pt, cfg = _moe_params("qwen3_moe_235b")
    x = torch.zeros(1, 2, cfg.d_model)
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        tmoe.apply_moe_shardmap(pt, x, cfg)
    with pytest.raises(NotImplementedError, match="mesh"):
        tmoe.apply_moe(pt, x, dataclasses.replace(cfg, moe_shardmap_dispatch=True))


# ---------------------------------------------------------------------------
# qkv bias and the tree
# ---------------------------------------------------------------------------


def test_attention_layer_qkv_bias():
    """Random nonzero biases added before RoPE, cached and cache-free."""
    jm, tm, jp, tp, cfg = _model("qwen2_moe_a2p7b")
    lp_j = jax.tree_util.tree_map(lambda a: a[1], jp["layers"]["attn"])
    lp_t = {k: v[1] for k, v in tp["layers"]["attn"].items()}
    assert float(jnp.abs(lp_j["bq"]).min()) > 0
    x = _rng(6).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    want, _ = JL.attention_layer(lp_j, jnp.asarray(x), cfg, causal=True, positions=jnp.arange(3, 8))
    _close(TL.attention_layer(lp_t, _t(x), cfg, causal=True, positions=torch.arange(3, 8)), want)
    no_bias = {k: v for k, v in lp_t.items() if not k.startswith("b")}
    assert (TL.attention_layer(no_bias, _t(x), cfg, causal=True) - _t(want)).abs().max() > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_match_the_jax_tree(arch):
    jm, tm, jp, tp, cfg = _model(arch)
    _, tcfg = _cfgs(arch)
    ours = t_init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), ours) == shapes
    assert ours["layers"]["moe"]["router"].dtype == torch.float32
    if tcfg.qkv_bias:
        assert not ours["layers"]["attn"]["bq"].any()
    # the JAX init scales: 1 / sqrt of each unstacked leaf's first dim (E for the experts)
    w = ours["layers"]["moe"]["w_gate"]
    assert abs(float(w.std()) - 1 / np.sqrt(tcfg.n_experts)) < 0.05 / np.sqrt(tcfg.n_experts)
    full = t_config("qwen2_moe_a2p7b")
    assert (full.n_layers, full.d_model, full.n_heads, full.head_dim, full.n_experts, full.top_k,
            full.moe_d_ff, full.shared_expert_d_ff, full.vocab_size, full.qkv_bias) == (
        24, 2048, 16, 128, 60, 4, 1408, 5632, 151936, True)


def test_refuses_what_is_not_ported():
    _, tcfg = _cfgs("qwen2_moe_a2p7b")
    with pytest.raises(ValueError, match="MoE decoder"):
        t_build(dataclasses.replace(tcfg, n_experts=0))
    with pytest.raises(ValueError, match="MoE decoder"):
        t_build(dataclasses.replace(tcfg, norm="layernorm"))
    with pytest.raises(ValueError, match="MoE decoder"):
        t_build(dataclasses.replace(tcfg, tie_embeddings=True))


# ---------------------------------------------------------------------------
# the model's decode methods
# ---------------------------------------------------------------------------


def test_forward_token_exit(dec):
    """All B x S tokens route together in both packages."""
    jm, tm, jp, tp, cfg = dec
    toks = _rng(10).integers(4, cfg.vocab_size, (2, 12))
    lg0, _ = jm.forward_token_exit(jp, jnp.asarray(toks), -1.0)
    mid = float(np.median(np.asarray(jdispatch.entropy(lg0))))
    for thr in (-1.0, mid, np.inf):
        lg_j, xl_j = jm.forward_token_exit(jp, jnp.asarray(toks), thr)
        lg_t, xl_t = tm.forward_token_exit(tp, _t(toks), thr)
        np.testing.assert_array_equal(xl_t.numpy(), np.asarray(xl_j))
        _close(lg_t, lg_j)


def test_decode_step_batched_and_per_lane(dec):
    """``moe_per_lane=False`` against the JAX model's batched call (8 lanes
    route together, scalar position); the default against the JAX serving
    step's lane vmap at per-lane positions."""
    jm, tm, jp, tp, cfg = dec
    jc = _filled_jcache(cfg, 8, 16, 6)
    toks = _rng(7).integers(4, cfg.vocab_size, (8, 1))
    lg_j, jc2 = jm.decode_step(jp, jc, jnp.asarray(toks), 5)
    tc = _tcache(jc)
    lg_t, tc = tm.decode_step(tp, tc, _t(toks), 5, moe_per_lane=False)
    _close(lg_t, lg_j)
    for k in ("k", "v"):
        _close(tc[k], jc2[k])
    pos = np.array([0, 3, 9, 15, 1, 2, 7, 12], np.int32)
    lg_j, jc3 = jsm.decoder_decode(jm, jp, jc, jnp.asarray(toks), jnp.asarray(pos))
    tc = _tcache(jc)
    lg_t, tc = tsm.decoder_decode(tm, tp, tc, _t(toks), _t(pos))
    _close(lg_t, lg_j)
    for k in ("k", "v"):
        _close(tc[k], jc3[k])


def test_decode_step_ee_per_lane(dec):
    """8 lanes at their own positions against step_math.decoder_decode_ee
    (the JAX Pallas entropy in interpret mode; the port's plain version)."""
    jm, tm, jp, tp, cfg = dec
    jc = _filled_jcache(cfg, 8, 16, 8)
    toks = _rng(9).integers(4, cfg.vocab_size, (8, 1))
    pos = np.array([0, 3, 9, 15, 1, 2, 7, 12], np.int32)
    _, _, _, fe = jsm.decoder_decode_ee(jm, jp, jc, jnp.asarray(toks), jnp.asarray(pos), -1.0)
    for thr in (-1.0, float(np.median(np.asarray(fe))), np.inf):
        lg_j, jc2, xl_j, fe_j = jsm.decoder_decode_ee(jm, jp, jc, jnp.asarray(toks), jnp.asarray(pos), thr,
                                                      use_pallas=True)
        tc = _tcache(jc)
        lg_t, tc, xl_t, fe_t = tsm.decoder_decode_ee(tm, tp, tc, _t(toks), _t(pos), thr, use_kernels=True)
        np.testing.assert_array_equal(xl_t.numpy(), np.asarray(xl_j))
        _close(lg_t, lg_j)
        _close(fe_t, fe_j)
        for k in ("k", "v"):
            _close(tc[k], jc2[k])


def test_decode_step_spec_per_lane(dec):
    """Self-speculative step over 8 lanes, W = 3, one threshold row per
    lane: tokens, accept masks, exits, logits, first entropies and the
    cache, against step_math.decoder_decode_spec."""
    jm, tm, jp, tp, cfg = dec
    jc = _filled_jcache(cfg, 8, 16, 11)
    toks = _rng(12).integers(4, cfg.vocab_size, (8, 1))
    pos = np.array([2, 7, 13, 0, 4, 5, 9, 11], np.int32)
    _, _, _, fe = jsm.decoder_decode_ee(jm, jp, jc, jnp.asarray(toks), jnp.asarray(pos), -1.0)
    base = float(np.quantile(np.asarray(fe), 0.9))
    thr = (base + _rng(13).uniform(-0.002, 0.01, (8, 3))).astype(np.float32)
    want = jsm.decoder_decode_spec(jm, jp, jc, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(thr), 3,
                                   use_pallas=True)
    tc = _tcache(jc)
    got = tsm.decoder_decode_spec(tm, tp, tc, _t(toks), _t(pos), _t(thr), 3, use_kernels=True)
    for i in (0, 3, 5):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    _close(got[1], want[1])
    _close(got[4], want[4])
    for k in ("k", "v"):
        _close(got[2][k], want[2][k])


def test_prefill(dec):
    """The model's prefill routes the whole [B, S] batch together."""
    jm, tm, jp, tp, cfg = dec
    toks = _rng(14).integers(4, cfg.vocab_size, (2, 20))
    jc = _filled_jcache(cfg, 2, 24, 15)
    lg_j, jc2 = jm.prefill(jp, jnp.asarray(toks), jc)
    tc = _tcache(jc)
    lg_t, tc = tm.prefill(tp, _t(toks), tc)
    _close(lg_t, lg_j)
    for k in ("k", "v"):
        _close(tc[k], jc2[k])


@pytest.mark.parametrize("lanes,lane", [(3, 1), (8, 6), (8, 2)])
def test_decoder_prefill(dec, lanes, lane):
    """The serving prefill of one lane against the JAX package's (every
    lane stepped, token 0 outside the lane): at 3 lanes the port's
    row-only shortcut, at 8 lanes (more than the capacity of 4) the port
    steps every lane as the reference does; the other lanes untouched."""
    jm, tm, jp, tp, cfg = dec
    jc = _filled_jcache(cfg, lanes, 16, 16)
    toks = np.zeros(16, np.int32)
    toks[:9] = _rng(17).integers(4, cfg.vocab_size, 9)
    want = jsm.decoder_prefill(jm, jp, jc, jnp.asarray(toks), jnp.int32(lane), jnp.int32(9), lanes)
    tc = _tcache(jc)
    got = tsm.decoder_prefill(tm, tp, tc, toks, lane, 9)
    others = [i for i in range(lanes) if i != lane]
    for k in ("k", "v"):
        _close(got[k], want[k])
        np.testing.assert_array_equal(got[k][:, others].numpy(), np.asarray(jc[k])[:, others])


def test_prefill_at_eight_lanes_differs_from_the_lane_alone():
    """What the all-lane path is for: at 8 lanes the dummy lanes (token 0)
    take the capacity of the experts they share with a high lane, so the
    JAX package's prefill differs from stepping the lane alone."""
    jm, tm, jp, tp, cfg = _model("qwen2_moe_a2p7b")
    jc = _filled_jcache(cfg, 8, 16, 16)
    toks = np.zeros(16, np.int32)
    toks[:9] = _rng(17).integers(4, cfg.vocab_size, 9)
    want = jsm.decoder_prefill(jm, jp, jc, jnp.asarray(toks), jnp.int32(6), jnp.int32(9), 8)
    alone = _tcache(jc)
    row = {k: v[:, 6:7] for k, v in alone.items()}
    for t in range(8):
        tm.decode_step(tp, row, torch.tensor([[int(toks[t])]]), t)
    assert np.abs(alone["k"][:, 6].numpy() - np.asarray(want["k"])[:, 6]).max() > 1e-3


def test_per_lane_routing_keeps_what_joint_routing_drops():
    """Eight lanes whose tokens pick the same experts: routed together
    (capacity 4) half of them lose those experts; routed per lane, as the
    JAX serving step does, every lane keeps every assignment and equals a
    one-lane call."""
    jm, tm, jp, tp, cfg = _model("qwen2_moe_a2p7b")
    _, pt, _ = _moe_params("qwen2_moe_a2p7b")
    x = np.tile((0.5 * _rng(18).standard_normal(cfg.d_model)).astype(np.float32), (8, 1, 1))
    joint = _t_dropped(pt, x, cfg, 1.25, grouped=False)
    assert len(joint) == 4 * cfg.top_k
    assert not _t_dropped(pt, x, cfg, 1.25, grouped=True)
    jc = {k: jnp.tile(v, (1, 8, 1, 1, 1)) for k, v in _filled_jcache(cfg, 1, 16, 20).items()}
    toks = np.full((8, 1), 77)
    pos = np.full(8, 5, np.int32)
    lg_t, _ = tm.decode_step(tp, _tcache(jc), _t(toks), _t(pos))
    lg_joint, _ = tm.decode_step(tp, _tcache(jc), _t(toks), _t(pos), moe_per_lane=False)
    lg_j, _ = jsm.decoder_decode(jm, jp, jc, jnp.asarray(toks), jnp.asarray(pos))
    _close(lg_t, lg_j)
    assert np.abs(lg_joint.numpy() - np.asarray(lg_j)).max() > 1e-3

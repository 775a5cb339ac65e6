"""The vision decoder family (llama-3.2-vision), port against the JAX
package, at model level: the tree, the cache, the gated cross layer,
``init_cache`` -> ``prefill(aux={"image_embeds": ...})`` ->
``decode_step``.

The smoke ``llama3_2_vision_90b`` config (4 layers: 2 groups of 1 self
layer and 1 cross layer, d_model 64, 8 query heads over 2 KV heads of 8,
d_ff 128, 16 image tokens, vocab 512) in float32.  The JAX package
initialises the params; the cross layers' gates, zero at init (each cross
layer then the identity, so the image would never reach the logits), are
set nonzero in the numpy tree, and the weight bridge carries it across.
Tokens and image embeddings (x 0.1, as the JAX tests scale theirs: the
vision frontend is a stub in both packages) are made by numpy from a seed.

Tolerances: atol 1e-5 on layer outputs and logits (magnitudes below 1),
2e-5 on every cache leaf (the K/V rows reach ~3); a batched decode step at
per-lane positions equals the JAX package's one-lane calls within 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as j_smoke
from repro.models.model import build_model as j_build
from repro_torch.bridge import load_npz_checkpoint, params_from_numpy
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import get_config as t_config
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.models.model import build_model as t_build
from repro_torch.models.model import init_params as t_init

ATOL = 1e-5
CACHE_ATOL = 2e-5
ARCH = "llama3_2_vision_90b"
GATES = {"gate_attn": (0.7, -0.5), "gate_mlp": (0.4, 0.9)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module (see test_torch_decode.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return tuple(dataclasses.replace(get(ARCH), dtype="float32", remat_policy="none", **kw)
                 for get in (j_smoke, t_smoke))


def _numpy_tree(jm, seed=1, gates=True):
    jp = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.PRNGKey(seed)))
    if gates:
        for name, vals in GATES.items():
            jp["cross_layers"][name] = np.asarray(vals, np.float32)
    return jp


@pytest.fixture(scope="module")
def vl():
    jcfg, tcfg = _cfgs()
    jm, tm = j_build(jcfg), t_build(tcfg)
    jp = _numpy_tree(jm)
    return jm, tm, jax.tree_util.tree_map(jnp.asarray, jp), params_from_numpy(jp, device="cpu"), tcfg


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).detach().float()),
                               np.asarray(want, np.float32), atol=atol, rtol=0)


def _close_cache(cache, jcache):
    assert sorted(cache) == sorted(jcache) == ["img_k", "img_v", "k", "v"]
    for k in jcache:
        _close(cache[k], jcache[k], atol=CACHE_ATOL)


def _image(cfg, B, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, cfg.n_image_tokens, cfg.d_model)) * 0.1).astype(np.float32)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _prefilled(vl, B=2, S=9, seed=3):
    """The JAX prefill of S tokens over a seeded image, and the port's from
    the same inputs: (JAX logits, JAX cache, port logits, port cache)."""
    jm, tm, jp, tp, cfg = vl
    img, toks = _image(cfg, B, seed), _tokens(cfg, B, S, seed + 1)
    lg_j, jc = jm.prefill(jp, jnp.asarray(toks), jm.init_cache(B, 32), aux={"image_embeds": jnp.asarray(img)})
    lg_t, tc = tm.prefill(tp, _t(toks), tm.init_cache(B, 32, device="cpu"), aux={"image_embeds": _t(img)})
    return lg_j, jc, lg_t, tc


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


_JDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# ---------------------------------------------------------------------------
# the config, the tree and the cache
# ---------------------------------------------------------------------------


def test_full_config_is_the_published_one():
    """llama-3.2-vision-90b field for field: 100 layers (80 self, 20 cross:
    every 5th), d_model 8192, 64 x 128 query heads over 8 KV heads, d_ff
    28672, vocab 128256, SwiGLU, RMS norms, rope theta 5e5, 1601 image
    tokens; the JAX tree at that size holds 87.67 B parameters."""
    cfg = t_config(ARCH)
    assert (cfg.family, cfg.n_layers, cfg.cross_attn_every, cfg.d_model, cfg.n_heads, cfg.n_kv_heads) == (
        "vlm", 100, 5, 8192, 64, 8)
    assert (cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.act, cfg.norm, cfg.pos, cfg.rope_theta,
            cfg.n_image_tokens) == (128, 28672, 128256, "swiglu", "rms", "rope", 500000.0, 1601)
    from repro.configs.base import get_config as j_config

    shapes = jax.eval_shape(j_build(j_config(ARCH)).init_params, jax.random.PRNGKey(0))
    n = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    assert round(n / 1e9, 2) == 87.67


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_matches_jax(dtype):
    """Keys, shapes and dtypes of ``init_params`` equal the JAX tree's (the
    self layers [n - n / every] and the cross layers [n / every], their
    gates float32 and zero), and the init scales."""
    jcfg, tcfg = (dataclasses.replace(get(ARCH), dtype=dtype) for get in (j_smoke, t_smoke))
    jt = _flat(jax.eval_shape(j_build(jcfg).init_params, jax.random.PRNGKey(0)))
    tt = _flat(t_init(tcfg, torch.Generator().manual_seed(0), device="cpu"))
    assert sorted(jt) == sorted(tt)
    for k, a in jt.items():
        assert tuple(tt[k].shape) == tuple(a.shape), k
        assert tt[k].dtype == _JDT[str(a.dtype)], k
    assert tt["layers/attn/wq"].shape[0] == 2 and tt["cross_layers/xattn/wk"].shape[0] == 2
    assert not tt["cross_layers/gate_attn"].any() and not tt["cross_layers/gate_mlp"].any()
    jv = _flat(j_build(jcfg).init_params(jax.random.PRNGKey(0)))
    for k in ("layers/attn/wq", "layers/mlp/w_gate", "cross_layers/xattn/wk", "cross_layers/mlp/w_down",
              "lm_head", "embed/tok"):
        sd_t, sd_j = tt[k].float().std().item(), float(np.asarray(jv[k], np.float32).std())
        assert abs(sd_t - sd_j) < 0.1 * sd_j, (k, sd_t, sd_j)


@pytest.mark.parametrize("kv_cache_dtype", ["", "af8"])
def test_init_cache_matches_jax(kv_cache_dtype):
    """The self layers' K/V [n_self, B, max_seq, KV, hd] (uint8 AF8 codes
    with ``kv_cache_dtype="af8"``) and the image K/V [n_cross, B, n_img,
    KV, hd] in the model dtype, all zero."""
    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg = (dataclasses.replace(get(ARCH), dtype=dtype, kv_cache_dtype=kv_cache_dtype)
                      for get in (j_smoke, t_smoke))
        jc, tc = j_build(jcfg).init_cache(3, 16), t_build(tcfg).init_cache(3, 16, device="cpu")
        assert sorted(jc) == sorted(tc) == ["img_k", "img_v", "k", "v"]
        for k in jc:
            assert tuple(tc[k].shape) == jc[k].shape and tc[k].dtype == _JDT.get(str(jc[k].dtype), torch.uint8), k
            assert not tc[k].any()


def test_bridge_and_checkpoint_carry_the_cross_layers(vl, tmp_path):
    """``params_from_numpy`` and ``load_npz_checkpoint`` carry the
    ``cross_layers`` tree, its 0-d-per-layer gates included, exactly."""
    jm, _, jp, tp, _ = vl
    want = _flat(jax.tree_util.tree_map(np.asarray, jp))
    got = _flat(tp)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert got["cross_layers/gate_attn"].shape == (2,) and got["cross_layers/gate_attn"][0].shape == ()
    CheckpointManager(str(tmp_path), save_every=1).maybe_save(1, {"params": tp}, force=True)
    back = _flat(load_npz_checkpoint(str(tmp_path / "step_00000001"))["params"])
    for k in want:
        np.testing.assert_array_equal(np.asarray(back[k]), want[k], err_msg=k)


# ---------------------------------------------------------------------------
# the cross layer
# ---------------------------------------------------------------------------


def test_cross_layer_step_matches_jax(vl):
    """The training form: GQA attention (8 query heads over 2 KV heads)
    from the normed h to the image's keys and values, no mask, then the
    SwiGLU MLP, each through tanh of its gate."""
    jm, tm, jp, tp, cfg = vl
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    img = _image(cfg, 2, 5)
    for g in range(2):
        oj = jm._cross_layer_step(jax.tree_util.tree_map(lambda x: x[g], jp["cross_layers"]), jnp.asarray(h),
                                  jnp.asarray(img))
        ot = tm._cross_layer_step(tm._layer(tp, g, "cross_layers")[0], _t(h), _t(img))
        _close(ot, oj)


def test_cross_decode_matches_jax(vl):
    """The decode form against cached image K/V: what the layer adds."""
    jm, tm, jp, tp, cfg = vl
    rng = np.random.default_rng(6)
    h = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    ik, iv = (rng.standard_normal((3, cfg.n_image_tokens, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
              for _ in range(2))
    oj = jm._cross_decode(jax.tree_util.tree_map(lambda x: x[1], jp["cross_layers"]), jnp.asarray(h),
                          jnp.asarray(ik), jnp.asarray(iv))
    ot = tm._cross_decode(tm._layer(tp, 1, "cross_layers")[0], _t(h), _t(ik), _t(iv))
    _close(ot, oj)


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------


def test_prefill_matches_jax(vl):
    """The prefill projects the image to every cross layer's K/V, writes
    them and the self layers' K/V at 0..S-1; last-token logits."""
    lg_j, jc, lg_t, tc = _prefilled(vl)
    assert lg_t.shape == (2, 1, vl[4].vocab_size)
    _close(lg_t, lg_j)
    _close_cache(tc, jc)
    assert tc["img_k"].abs().max() > 0.1


def test_prefill_needs_the_image(vl):
    _, tm, _, tp, _ = vl
    for aux in (None, {}, {"enc_input": torch.zeros(1)}):
        with pytest.raises(ValueError, match="image_embeds"):
            tm.prefill(tp, torch.zeros((1, 4), dtype=torch.long), tm.init_cache(1, 8, device="cpu"), aux=aux)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_decode_step_matches_jax(vl, use_kernels):
    """Two decode steps after the prefill: logits and every cache leaf (the
    self K/V written in place, the image K/V read); no kernel is called on
    either route (the norms are RMS, cache and cross attention stay on the
    reference ops)."""
    jm, tm, jp, tp, _ = vl
    _, jc, _, tc = _prefilled(vl)
    calls = []
    real = tdispatch.layernorm, tdispatch.entropy
    tdispatch.layernorm = lambda *a, **k: calls.append("layernorm")
    tdispatch.entropy = lambda *a, **k: calls.append("entropy")
    try:
        for t, toks in enumerate((np.array([[5], [9]]), np.array([[44], [3]]))):
            lg_j, jc = jm.decode_step(jp, jc, jnp.asarray(toks), 9 + t, use_pallas=use_kernels)
            lg_t, tc2 = tm.decode_step(tp, tc, _t(toks), 9 + t, use_kernels=use_kernels)
            assert tc2 is tc
            _close(lg_t, lg_j)
            _close_cache(tc, jc)
    finally:
        tdispatch.layernorm, tdispatch.entropy = real
    assert calls == []


def test_decode_step_per_lane_positions(vl):
    """Lanes at their own positions in one call: each lane equals the JAX
    package's one-lane call at its scalar position."""
    jm, tm, jp, tp, cfg = vl
    _, jc, _, _ = _prefilled(vl, B=3, S=12)
    toks = np.array([[5], [9], [33]])
    pos = np.array([4, 9, 12])
    tc = {k: _t(v).clone() for k, v in jc.items()}
    lg, _ = tm.decode_step(tp, tc, _t(toks), _t(pos))
    for i in range(3):
        ji = jax.tree_util.tree_map(lambda x: x[:, i:i + 1], jc)
        lg_j, ji2 = jm.decode_step(jp, ji, jnp.asarray(toks[i:i + 1]), int(pos[i]))
        _close(lg[i], np.asarray(lg_j)[0])
        for k in ji2:
            _close(tc[k][:, i:i + 1], ji2[k], atol=CACHE_ATOL)


def test_a_second_image_moves_the_logits(vl):
    """Another image changes the prefill's and a decode step's logits (the
    gates are nonzero); at the init's zero gates it changes nothing."""
    jm, tm, _, tp, cfg = vl
    toks = _tokens(cfg, 2, 9, 7)

    def logits(params, seed):
        cache = tm.init_cache(2, 32, device="cpu")
        lg_p, cache = tm.prefill(params, _t(toks), cache, aux={"image_embeds": _t(_image(cfg, 2, seed))})
        lg_d, _ = tm.decode_step(params, cache, _t(toks[:, -1:]), 9)
        return lg_p, lg_d

    a, b = logits(tp, 1), logits(tp, 2)
    assert (a[0] - b[0]).abs().max() > 1e-3 and (a[1] - b[1]).abs().max() > 1e-3
    zero = params_from_numpy(_numpy_tree(jm, gates=False), device="cpu")
    a, b = logits(zero, 1), logits(zero, 2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_decode_consistency(vl):
    """``tests/test_models.py::test_decode_consistency`` for the vlm on the
    port: prefill(prompt, image) and decode_step(token) logits against the
    JAX full forward at the same positions (1e-5 here, where the reference
    holds its own at 2e-2), and against the JAX prefill and decode_step."""
    jm, tm, jp, tp, cfg = vl
    B, S = 2, 24
    rng = jax.random.PRNGKey(2)
    tokens = np.asarray(jax.random.randint(rng, (B, S), 0, cfg.vocab_size))
    img = np.asarray(jax.random.normal(rng, (B, cfg.n_image_tokens, cfg.d_model)) * 0.1)
    full = jm.apply_train(jp, {"tokens": jnp.asarray(tokens), "image_embeds": jnp.asarray(img)}).logits
    jc = jm.init_cache(B, 64)
    lg_pj, jc = jm.prefill(jp, jnp.asarray(tokens[:, :S - 1]), jc, aux={"image_embeds": jnp.asarray(img)})
    lg_dj, jc = jm.decode_step(jp, jc, jnp.asarray(tokens[:, S - 1:]), S - 1)
    tc = tm.init_cache(B, 64, device="cpu")
    lg_p, tc = tm.prefill(tp, _t(tokens[:, :S - 1]), tc, aux={"image_embeds": _t(img)})
    _close(lg_p[:, 0], full[:, S - 2])
    lg_d, tc = tm.decode_step(tp, tc, _t(tokens[:, S - 1:]), S - 1)
    _close(lg_d[:, 0], full[:, S - 1])
    _close(lg_p, lg_pj)
    _close(lg_d, lg_dj)
    _close_cache(tc, jc)


# ---------------------------------------------------------------------------
# what the family does not have
# ---------------------------------------------------------------------------


def test_vlm_refusals(vl):
    """Per-token exit, speculative decode and the token-exit forward do not
    exist for the family in the JAX package (it asserts): ValueError.  The
    model refuses the configurations it does not port."""
    _, tm, _, tp, _ = vl
    cache = tm.init_cache(1, 8, device="cpu")
    tok = torch.tensor([[3]])
    with pytest.raises(ValueError, match="per-token exit"):
        tm.decode_step_ee(tp, cache, tok, 0, 1.0)
    with pytest.raises(ValueError, match="per-token exit"):
        tm.decode_step_spec(tp, cache, tok, 0, 1.0, 2)
    with pytest.raises(ValueError, match="token exit"):
        tm.forward_token_exit(tp, np.zeros((1, 4), np.int64), 1.0)
    _, tcfg = _cfgs()
    for bad in (dict(act="gelu"), dict(norm="layernorm"), dict(qkv_bias=True), dict(n_layers=5),
                dict(cross_attn_every=0), dict(tie_embeddings=True)):
        with pytest.raises(ValueError, match="vision decoder"):
            t_build(dataclasses.replace(tcfg, **bad))
        with pytest.raises(ValueError, match="vision decoder"):
            t_init(dataclasses.replace(tcfg, **bad), device="cpu")

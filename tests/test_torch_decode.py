"""The dense decoder's model math, port against the JAX package.

The smoke ``deepseek_7b`` config (2 layers, d_model 64, 8 x 8 heads, d_ff
96, vocab 512) in float32; the JAX package initialises the params, the
weight bridge carries them across, and every input is made by numpy from a
seed.  The port's decode methods take a ``[B]`` tensor of cache positions
and write the cache in place, so each test hands them a copy of the JAX
cache and compares the cache that comes out.

Tolerances: atol 1e-5 on logits, hidden states, caches and entropies
(float32 sums in another order; the JAX package's own gap between its two
routes is of that size); exit layers, tokens, accept masks and AF8 cache
codes equal; the decoder's exit-depth predictors (numpy in both packages)
exactly equal.  The claims the JAX package makes bit for bit inside itself
(no-exit early-exit decode equals ``decode_step``; a spec window of 1
equals ``decode_step_ee``; a batched call equals one-lane calls) are held
bit for bit inside the port where the shapes are the same, and within
1e-5 across lane counts, where GEMMs at M = 1 and M = 4 may round
differently.

On the CPU the port's kernel route (``use_kernels=True``) runs the plain
versions; the JAX side runs its Pallas entropy kernel in interpret mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as j_smoke
from repro.core import early_exit as jee
from repro.core.adaptivfloat import af_decode_static as j_af_decode_static
from repro.core.adaptivfloat import af_encode_static as j_af_encode_static
from repro.kernels import dispatch as jdispatch
from repro.models import layers as JL
from repro.models.model import build_model as j_build
from repro.serving import step_math as jsm
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config as t_config
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.core import early_exit as tee
from repro_torch.core.adaptivfloat import af_decode_static, af_encode_static
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.models import layers as TL
from repro_torch.models.model import build_model as t_build
from repro_torch.models.model import init_params as t_init
from repro_torch.serving import step_math as tsm

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the smoke-size steps are many
    tiny ops, and under the suite's parallel workers torch's default pool
    per process oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return tuple(dataclasses.replace(get("deepseek_7b"), dtype="float32", remat_policy="none", **kw)
                 for get in (j_smoke, t_smoke))


@pytest.fixture(scope="module")
def dec():
    jcfg, tcfg = _cfgs()
    jm, tm = j_build(jcfg), t_build(tcfg)
    jp = jm.init_params(jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jm, tm, jp, tp, jcfg


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


def _tcache(jcache):
    return {k: _t(v) for k, v in jcache.items()}


def _filled_jcache(jm, cfg, B, S, seed):
    """A JAX cache of B lanes with random K/V everywhere (float32), so that
    reads of unwritten columns would show."""
    r = _rng(seed)
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
    return {k: jnp.asarray(r.standard_normal(shape).astype(np.float32)) for k in ("k", "v")}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_rms_norm():
    r = _rng(0)
    x = r.standard_normal((3, 5, 64)).astype(np.float32) * 3.0
    scale = (1.0 + 0.1 * r.standard_normal(64)).astype(np.float32)
    want = JL.apply_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x), "rms")
    got = TL.apply_norm({"scale": _t(scale)}, _t(x), kind="rms")
    _close(got, want)


@pytest.mark.parametrize("per_lane", [False, True])
def test_rope(per_lane):
    r = _rng(1)
    x = r.standard_normal((3, 4, 8, 16)).astype(np.float32)
    if per_lane:
        pos = np.array([0, 7, 30])[:, None] + np.arange(4)
        want = np.stack([np.asarray(JL.apply_rope(jnp.asarray(x[i:i + 1]), jnp.asarray(pos[i]), 10000.0))[0]
                         for i in range(3)])
    else:
        pos = np.arange(5, 9)
        want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = TL.apply_rope(_t(x), _t(pos), 10000.0)
    _close(got, want)
    _close(TL.rope_freqs(16, 10000.0), JL.rope_freqs(16, 10000.0), atol=0)


def test_swiglu_mlp(dec):
    jm, tm, jp, tp, cfg = dec
    x = _rng(2).standard_normal((2, 3, cfg.d_model)).astype(np.float32)
    lp_j = jax.tree_util.tree_map(lambda a: a[1], jp["layers"]["mlp"])
    lp_t = {k: v[1] for k, v in tp["layers"]["mlp"].items()}
    want = JL.apply_mlp(lp_j, jnp.asarray(x), "swiglu")
    _close(TL.apply_mlp(lp_t, _t(x), act="swiglu"), want)


def test_af8_static_codec():
    x = (_rng(3).standard_normal((4, 5, 8)) * np.array([1e-3, 0.1, 1.0, 4.0, 20.0])[None, :, None]).astype(np.float32)
    codes_j = np.asarray(j_af_encode_static(jnp.asarray(x), -5))
    codes_t = af_encode_static(_t(x), -5)
    np.testing.assert_array_equal(codes_t.numpy(), codes_j)
    np.testing.assert_array_equal(af_decode_static(codes_t, -5).numpy(),
                                  np.asarray(j_af_decode_static(jnp.asarray(codes_j), -5)))


@pytest.mark.parametrize("kv", ["", "af8"])
def test_cached_attention_layer(kv):
    """attention_layer with a cache, per-lane positions: the new column
    written at each lane's cache_pos, q at cache_pos, cache_pos + S keys;
    against the JAX function called one lane at a time with a scalar
    position (its vmapped use)."""
    jcfg, tcfg = _cfgs(kv_cache_dtype=kv)
    jp = j_build(jcfg).init_params(jax.random.PRNGKey(2))
    lp_j = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["attn"])
    lp_t = {k: _t(v) for k, v in lp_j.items()}
    B, Smax, S = 3, 16, 1
    r = _rng(4)
    x = r.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    shape = (B, Smax, tcfg.n_kv_heads, tcfg.head_dim)
    if kv == "af8":
        ck = r.integers(0, 256, shape).astype(np.uint8)
        cv = r.integers(0, 256, shape).astype(np.uint8)
    else:
        ck = r.standard_normal(shape).astype(np.float32)
        cv = r.standard_normal(shape).astype(np.float32)
    pos = np.array([0, 5, 15])
    outs, kcs, vcs = [], [], []
    for i in range(B):
        o, (kc, vc) = JL.attention_layer(
            lp_j, jnp.asarray(x[i:i + 1]), jcfg, causal=True, positions=jnp.asarray(pos[i] + np.arange(S)),
            cache=(jnp.asarray(ck[i:i + 1]), jnp.asarray(cv[i:i + 1])), cache_pos=int(pos[i]))
        outs.append(np.asarray(o)[0])
        kcs.append(np.asarray(kc)[0])
        vcs.append(np.asarray(vc)[0])
    tk, tv = _t(ck), _t(cv)
    got = TL.attention_layer(lp_t, _t(x), tcfg, causal=True, positions=_t(pos[:, None] + np.arange(S)),
                             cache=(tk, tv), cache_pos=_t(pos))
    _close(got, np.stack(outs))
    if kv == "af8":
        np.testing.assert_array_equal(tk.numpy(), np.stack(kcs))
        np.testing.assert_array_equal(tv.numpy(), np.stack(vcs))
    else:
        _close(tk, np.stack(kcs))
        _close(tv, np.stack(vcs))


def test_cached_attention_write_past_the_end_moves_back():
    """A write that would run past the cache's end lands where JAX's
    dynamic_update_slice puts it (moved back to end there), while the
    queries keep their own position."""
    jcfg, tcfg = _cfgs()
    jp = j_build(jcfg).init_params(jax.random.PRNGKey(2))
    lp_j = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["attn"])
    lp_t = {k: _t(v) for k, v in lp_j.items()}
    r = _rng(5)
    x = r.standard_normal((1, 2, tcfg.d_model)).astype(np.float32)
    ck = r.standard_normal((1, 8, tcfg.n_kv_heads, tcfg.head_dim)).astype(np.float32)
    cv = r.standard_normal(ck.shape).astype(np.float32)
    o, (kc, vc) = JL.attention_layer(lp_j, jnp.asarray(x), jcfg, causal=True, positions=jnp.arange(7, 9),
                                     cache=(jnp.asarray(ck), jnp.asarray(cv)), cache_pos=7)
    tk, tv = _t(ck), _t(cv)
    got = TL.attention_layer(lp_t, _t(x), tcfg, causal=True, positions=torch.arange(7, 9),
                             cache=(tk, tv), cache_pos=7)
    _close(got, o)
    _close(tk, kc)
    _close(tv, vc)


# ---------------------------------------------------------------------------
# the model's decode methods
# ---------------------------------------------------------------------------


def test_init_params_and_cache_match_the_jax_tree(dec):
    jm, tm, jp, tp, cfg = dec
    _, tcfg = _cfgs()
    ours = t_init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), ours) == shapes
    for kv, dtype in (("", np.float32), ("af8", np.uint8)):
        jc, tc = _cfgs(kv_cache_dtype=kv)
        want = j_build(jc).init_cache(3, 16)
        got = t_build(tc).init_cache(3, 16, device="cpu")
        for k in ("k", "v"):
            assert tuple(got[k].shape) == want[k].shape and np.asarray(want[k]).dtype == dtype
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # the full config's tree: the JAX package's keys, layers stacked on 30
    full = t_config("deepseek_7b")
    assert (full.n_layers, full.d_model, full.n_heads, full.head_dim, full.d_ff, full.vocab_size) == (
        30, 4096, 32, 128, 11008, 102400)


def test_decode_step(dec):
    jm, tm, jp, tp, cfg = dec
    jc = _filled_jcache(jm, cfg, 2, 16, 6)
    tc = _tcache(jc)
    toks = np.array([[5], [9]])
    for pos in (0, 3, 15):
        lg_j, jc = jm.decode_step(jp, jc, jnp.asarray(toks), pos)
        lg_t, tc = tm.decode_step(tp, tc, _t(toks), pos)
        _close(lg_t, lg_j)
        for k in ("k", "v"):
            _close(tc[k], jc[k])


@pytest.mark.parametrize("threshold", [-1.0, "mid", np.inf])
def test_decode_step_ee(dec, threshold):
    """Batched call, scalar position: logits, exit layers, first entropies
    and the cache (frozen tokens still write every layer's K/V)."""
    jm, tm, jp, tp, cfg = dec
    jc = _filled_jcache(jm, cfg, 4, 16, 7)
    toks = np.array([[5], [9], [300], [41]])
    if threshold == "mid":
        _, _, _, fe = jm.decode_step_ee(jp, jc, jnp.asarray(toks), 4, -1.0)
        threshold = float(np.median(np.asarray(fe)))
    lg_j, jc2, xl_j, fe_j = jm.decode_step_ee(jp, jc, jnp.asarray(toks), 4, threshold)
    tc = _tcache(jc)
    for use_kernels in (False, True):
        tc = _tcache(jc)
        lg_t, tc, xl_t, fe_t = tm.decode_step_ee(tp, tc, _t(toks), 4, threshold, use_kernels=use_kernels)
        np.testing.assert_array_equal(xl_t.numpy(), np.asarray(xl_j))
        _close(lg_t, lg_j)
        _close(fe_t, fe_j)
        for k in ("k", "v"):
            _close(tc[k], jc2[k])


def test_decode_step_ee_per_lane_positions_match_vmapped_lanes(dec):
    """Each lane at its own position (the serving step): against the JAX
    package's lane vmap (step_math.decoder_decode_ee)."""
    jm, tm, jp, tp, cfg = dec
    jc = _filled_jcache(jm, cfg, 4, 16, 8)
    toks = np.array([[5], [9], [300], [41]])
    pos = np.array([0, 3, 9, 15], np.int32)
    _, _, _, fe = jsm.decoder_decode_ee(jm, jp, jc, jnp.asarray(toks), jnp.asarray(pos), -1.0)
    thr = float(np.median(np.asarray(fe)))
    lg_j, jc2, xl_j, fe_j = jsm.decoder_decode_ee(jm, jp, jc, jnp.asarray(toks), jnp.asarray(pos), thr,
                                                  use_pallas=True)
    tc = _tcache(jc)
    lg_t, tc, xl_t, fe_t = tsm.decoder_decode_ee(tm, tp, tc, _t(toks), _t(pos), thr, use_kernels=True)
    np.testing.assert_array_equal(xl_t.numpy(), np.asarray(xl_j))
    _close(lg_t, lg_j)
    _close(fe_t, fe_j)
    for k in ("k", "v"):
        _close(tc[k], jc2[k])
    # the plain decode too
    lg_j, jc3 = jsm.decoder_decode(jm, jp, jc, jnp.asarray(toks), jnp.asarray(pos))
    tc = _tcache(jc)
    lg_t, tc = tsm.decoder_decode(tm, tp, tc, _t(toks), _t(pos))
    _close(lg_t, lg_j)
    for k in ("k", "v"):
        _close(tc[k], jc3[k])


@pytest.mark.parametrize("eos", [-1, "second"])
def test_decode_step_spec_matches_vmapped_lanes(dec, eos):
    """Self-speculative step over 3 lanes at their own positions, one
    threshold row per lane, W = 3: tokens, accept masks, exits, logits,
    first entropies and the cache, against step_math.decoder_decode_spec."""
    jm, tm, jp, tp, cfg = dec
    jc = _filled_jcache(jm, cfg, 3, 16, 9)
    toks = np.array([[5], [9], [300]])
    pos = np.array([2, 7, 13], np.int32)           # lane 2 runs past the end
    _, _, _, fe = jsm.decoder_decode_ee(jm, jp, jc, jnp.asarray(toks), jnp.asarray(pos), -1.0)
    base = float(np.quantile(np.asarray(fe), 0.9))
    thr = (base + np.array([[0.0, 0.0, 0.0], [0.002, -0.001, 0.0], [0.01, 0.01, 0.01]])).astype(np.float32)
    eos_id = -1
    if eos == "second":
        out = jsm.decoder_decode_spec(jm, jp, jc, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(thr), 3)
        eos_id = int(np.asarray(out[0])[0, 0])
    want = jsm.decoder_decode_spec(jm, jp, jc, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(thr), 3,
                                   eos_id=eos_id, use_pallas=True)
    tc = _tcache(jc)
    got = tsm.decoder_decode_spec(tm, tp, tc, _t(toks), _t(pos), _t(thr), 3, eos_id=eos_id, use_kernels=True)
    for i in (0, 3, 5):                                # tokens, exits, accepted
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    _close(got[1], want[1])
    _close(got[4], want[4])
    for k in ("k", "v"):
        _close(got[2][k], want[2][k])


def test_forward_token_exit(dec):
    jm, tm, jp, tp, cfg = dec
    toks = _rng(10).integers(4, cfg.vocab_size, (2, 20))
    lg0, _ = jm.forward_token_exit(jp, jnp.asarray(toks), -1.0)
    mid = float(np.median(np.asarray(jdispatch.entropy(lg0))))
    for thr in (-1.0, mid, np.inf):
        lg_j, xl_j = jm.forward_token_exit(jp, jnp.asarray(toks), thr)
        lg_t, xl_t = tm.forward_token_exit(tp, _t(toks), thr)
        np.testing.assert_array_equal(xl_t.numpy(), np.asarray(xl_j))
        _close(lg_t, lg_j)
    assert np.asarray(lg0).shape == (2, 20, cfg.vocab_size)


def test_prefill(dec):
    jm, tm, jp, tp, cfg = dec
    toks = _rng(11).integers(4, cfg.vocab_size, (2, 20))
    jc = _filled_jcache(jm, cfg, 2, 24, 12)
    lg_j, jc2 = jm.prefill(jp, jnp.asarray(toks), jc)
    tc = _tcache(jc)
    lg_t, tc = tm.prefill(tp, _t(toks), tc)
    _close(lg_t, lg_j)
    for k in ("k", "v"):
        _close(tc[k], jc2[k])


def test_decoder_prefill_writes_only_its_lane(dec):
    """The serving prefill: prompt[:length - 1] through full-depth decode
    steps into one lane's cache row; the other lanes are untouched."""
    jm, tm, jp, tp, cfg = dec
    jc = _filled_jcache(jm, cfg, 3, 16, 13)
    toks = np.zeros(16, np.int32)
    toks[:7] = _rng(14).integers(4, cfg.vocab_size, 7)
    want = jsm.decoder_prefill(jm, jp, jc, jnp.asarray(toks), jnp.int32(1), jnp.int32(7), 3)
    tc = _tcache(jc)
    got = tsm.decoder_prefill(tm, tp, tc, toks, 1, 7)
    for k in ("k", "v"):
        _close(got[k], want[k])
        np.testing.assert_array_equal(got[k][:, [0, 2]].numpy(), np.asarray(jc[k])[:, [0, 2]])


# ---------------------------------------------------------------------------
# the LM-head entropy through dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 512), (2, 102400), (3, 1, 512)])
def test_dispatch_entropy(shape):
    """The port's dispatch.entropy (plain version on the CPU) against the
    JAX package's (its Pallas kernel in interpret mode)."""
    x = (_rng(15).standard_normal(shape) * 1.3).astype(np.float32)
    want = jdispatch.entropy(jnp.asarray(x))
    got = tdispatch.entropy(_t(x))
    assert tuple(got.shape) == shape[:-1]
    _close(got, want)


# ---------------------------------------------------------------------------
# the decoder's exit-depth predictors (numpy in both packages)
# ---------------------------------------------------------------------------


def test_position_binned_calibrator_matches():
    r = _rng(16)
    obs = [(int(p), int(x)) for p, x in zip(r.integers(0, 40, 300), r.integers(1, 31, 300))]
    cj = jee.PositionBinnedExitCalibrator(30, max_pos=32, n_bins=8, quantile=0.9, window=64)
    ct = tee.PositionBinnedExitCalibrator(30, max_pos=32, n_bins=8, quantile=0.9, window=64)
    assert ct.predict(3) == cj.predict(3) == 30.0
    for k, (p, x) in enumerate(obs):
        cj.observe(p, x)
        ct.observe(p, x)
        if k % 37 == 0:
            for q in (0, 5, 17, 31, 40):
                assert ct.predict(q) == cj.predict(q)
            assert ct.predict_range(2, 29) == cj.predict_range(2, 29)
    np.testing.assert_array_equal(ct.bin_exit, cj.bin_exit)
    np.testing.assert_array_equal(ct.bin_fill_counts(), cj.bin_fill_counts())
    assert ct.predict_range(5, 5) == cj.predict_range(5, 5) == 0.0
    for start, end in ((0, 8), (3, 40), (7, 7)):
        assert (tee.predicted_token_layers(ct.predict, start, end, 30)
                == jee.predicted_token_layers(cj.predict, start, end, 30))


def test_exit_threshold_schedule_matches():
    r = _rng(17)
    cal_j = jee.PositionBinnedExitCalibrator(30, max_pos=32)
    cal_t = tee.PositionBinnedExitCalibrator(30, max_pos=32)
    for p, x in zip(r.integers(0, 32, 200), r.integers(1, 31, 200)):
        cal_j.observe(int(p), int(x))
        cal_t.observe(int(p), int(x))
    kw = dict(position_edges=(4, 12), position_scales=(1.2, 1.0, 0.8), band_edges=(6.0, 6.2),
              band_scales=(1.3, 1.0, 0.9), min_threshold=0.5, max_threshold=7.0)
    pairs = [(jee.ExitThresholdSchedule(6.1, **kw), tee.ExitThresholdSchedule(6.1, **kw)),
             (jee.ExitThresholdSchedule(6.1), tee.ExitThresholdSchedule(6.1)),
             (jee.ExitThresholdSchedule.from_calibrator(6.1, cal_j),
              tee.ExitThresholdSchedule.from_calibrator(6.1, cal_t))]
    for sj, st in pairs:
        for start, count, last in ((0, 4, None), (3, 4, 5.9), (10, 6, 6.1), (30, 2, 6.5)):
            np.testing.assert_array_equal(st.thresholds(start, count, last), sj.thresholds(start, count, last))
            assert st.threshold_at(start, last) == sj.threshold_at(start, last)
    sj, st = pairs[2]
    sj.observe(3, 6.0, 4)
    st.observe(3, 6.0, 4)
    np.testing.assert_array_equal(cal_t.bin_exit, cal_j.bin_exit)


# ---------------------------------------------------------------------------
# the JAX package's bit-for-bit claims, inside the port
# ---------------------------------------------------------------------------


def test_no_exit_ee_equals_decode_step_bitwise(dec):
    jm, tm, jp, tp, cfg = dec
    jc = _filled_jcache(jm, cfg, 2, 16, 18)
    toks = _t(np.array([[5], [9]]))
    ca, cb = _tcache(jc), _tcache(jc)
    lg_ref, ca = tm.decode_step(tp, ca, toks, torch.tensor([0, 4]))
    lg, cb, xl, _ = tm.decode_step_ee(tp, cb, toks, torch.tensor([0, 4]), -1.0, use_kernels=True)
    assert (xl.numpy() == cfg.n_layers).all()
    assert torch.equal(lg, lg_ref)
    for k in ("k", "v"):
        assert torch.equal(ca[k], cb[k])


def test_spec_window_one_equals_ee_bitwise(dec):
    jm, tm, jp, tp, cfg = dec
    jc = _filled_jcache(jm, cfg, 3, 16, 19)
    toks = _t(np.array([[5], [9], [33]]))
    pos = torch.tensor([1, 6, 11])
    _, _, _, fe = tm.decode_step_ee(tp, _tcache(jc), toks, pos, -1.0)
    thr = float(fe.median())
    ca, cb = _tcache(jc), _tcache(jc)
    lg, ca, xl, fe = tm.decode_step_ee(tp, ca, toks, pos, thr, use_kernels=True)
    tk, lgs, cb, xls, fes, acc = tm.decode_step_spec(tp, cb, toks, pos, thr, 1, use_kernels=True)
    assert acc.all()
    assert torch.equal(lgs[:, 0], lg[:, 0]) and torch.equal(xls[:, 0], xl) and torch.equal(fes[:, 0], fe)
    assert torch.equal(tk[:, 0], lg[:, 0].argmax(-1))
    for k in ("k", "v"):
        assert torch.equal(ca[k], cb[k])


def test_batched_lanes_match_one_lane_calls(dec):
    """The JAX package vmaps one-lane calls; the port batches the lanes.
    Across lane counts the GEMMs run at other M and may round apart, so
    1e-5; exits equal."""
    jm, tm, jp, tp, cfg = dec
    jc = _filled_jcache(jm, cfg, 3, 16, 20)
    toks = np.array([[5], [9], [33]])
    pos = np.array([1, 6, 11])
    tc = _tcache(jc)
    lg, tc, xl, fe = tm.decode_step_ee(tp, tc, _t(toks), _t(pos), 6.2245)
    for i in range(3):
        ci = {k: v[:, i:i + 1].clone() for k, v in _tcache(jc).items()}
        lg1, ci, xl1, fe1 = tm.decode_step_ee(tp, ci, _t(toks[i:i + 1]), int(pos[i]), 6.2245)
        assert int(xl1[0]) == int(xl[i])
        _close(lg1[0], lg[i])
        _close(fe1[0], fe[i])
        for k in ("k", "v"):
            _close(ci[k][:, 0], tc[k][:, i])


def test_dense_family_refuses_what_is_not_ported():
    """The activations and the tied head and shared layers the decoders do
    not have (gelu stays refused for the dense family: only the encdec
    family takes it), the albert family without its one shared layer, and
    what the hybrid, encdec and vlm families do not have in the JAX package
    (per-token exit).  EdgeBERT's activation quantization is accepted (the
    features on every family: ``tests/test_torch_eb_decoders.py``).  Every
    decoder family's training forward is ported:
    ``tests/test_torch_train_forwards.py``."""
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="dense decoder"):
        t_build(dataclasses.replace(tcfg, act="gelu"))
    qcfg = tcfg.with_edgebert(quant=dataclasses.replace(tcfg.edgebert.quant, enabled=True))
    assert t_build(qcfg).cfg.edgebert.quant.enabled and "layers" in t_init(qcfg, device="cpu")
    for bad in (dict(tie_embeddings=True), dict(shared_layers=True)):
        with pytest.raises(ValueError, match="dense decoder"):
            t_build(dataclasses.replace(tcfg, **bad))
    assert t_build(tcfg).apply_train(t_init(tcfg, device="cpu"),
                                     {"tokens": np.zeros((1, 4), np.int32)}).logits.shape == (1, 4, tcfg.vocab_size)
    with pytest.raises(ValueError, match="families are ported"):
        t_build(dataclasses.replace(tcfg, family="albert"))
    with pytest.raises(ValueError, match="decoders are ported"):
        t_init(dataclasses.replace(tcfg, family="albert"), device="cpu")
    for arch in ("zamba2_1p2b", "whisper_medium", "llama3_2_vision_90b"):
        cfg = dataclasses.replace(t_smoke(arch), dtype="float32")
        model = t_build(cfg)
        params = t_init(cfg, device="cpu")
        with pytest.raises(ValueError, match="per-token exit"):
            model.decode_step_ee(params, model.init_cache(1, 8, device="cpu"), torch.tensor([[3]]), 0, 1.0)


def test_albert_family_prefill_and_decode_step():
    """The albert branch of prefill and decode_step (one shared post-LN
    layer, learned positions, soft spans, activation quantization over the
    whole batch: ``per_lane=False``, the JAX model's batched call; the
    default is the serving step's per-lane bias), scalar positions as the
    JAX package runs it.  atol 2e-4,
    the bound test_torch_serving.py holds the albert layer to: activation
    quantization turns a last-ulp difference at an AF rounding boundary
    into a quantum, and these inputs (seed 21) put no element on one."""
    jcfg, tcfg = (dataclasses.replace(get("albert_edgebert"), dtype="float32", remat_policy="none")
                  for get in (j_smoke, t_smoke))
    jm, tm = j_build(jcfg), t_build(tcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    toks = _rng(21).integers(4, jcfg.vocab_size, (2, 9))
    jc = jm.init_cache(2, 16)
    lg_j, jc = jm.prefill(jp, jnp.asarray(toks), jc)
    tc = tm.init_cache(2, 16, device="cpu")
    lg_t, tc = tm.prefill(tp, _t(toks), tc)
    _close(lg_t, lg_j, atol=2e-4)
    nxt = np.array([[5], [7]])
    lg_j, jc = jm.decode_step(jp, jc, jnp.asarray(nxt), 9)
    lg_t, tc = tm.decode_step(tp, tc, _t(nxt), 9, per_lane=False)
    _close(lg_t, lg_j, atol=2e-4)
    for k in ("k", "v"):
        _close(tc[k], jc[k], atol=2e-4)

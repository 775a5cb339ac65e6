"""The RWKV6 (ssm) family, port against the JAX package.

The smoke ``rwkv6_7b`` config (2 layers, d_model 64, 4 heads of 16, d_ff
128, vocab 512) in float32; the JAX package initialises the params, the
weight bridge carries them across, and every other input is made by numpy
from a seed.  The decay inputs of the WKV tests stay away from 0, where the
chunked form's ``log(max(w, 1e-38))`` and ``exp(min(-cum, 40))`` clamps
would bite: sigmoid(n + 2) (as the JAX package's own WKV tests draw them)
and exp(-exp(-6 + n / 4)), the random init's decay of about 0.9975.

Tolerances: atol 1e-5 on WKV outputs and states, layer outputs, logits and
states between the packages (float32 sums in another order), with rtol 1e-6
beside it on the WKV outputs and states: at a decay near 1 the state sums
tens of unit products and reaches 25 in magnitude, where 1e-5 is a few
float32 ulps; the model's recurrent state (the cache after a prefill or a
decode step) within 1e-5 of its leaf's largest magnitude (the WKV state of
the second layer reaches 26 after 24 tokens, and it sums products of the
first layer's outputs, which differ by float32 rounding); 1e-4 for the
chunked form against the recurrent one inside the port, as the JAX package
holds its own (``tests/test_models.py::TestWKV6``); 2e-2 for prefill and
decode against the full forward, as ``test_decode_consistency`` holds the
JAX package.  A batched decode step equals one-lane steps within 1e-5
(GEMMs at another M may round differently).

On the CPU the port's kernel route (``use_kernels=True``) runs the plain
versions; the JAX side runs its Pallas layernorm kernel in interpret mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as j_smoke
from repro.models import rwkv6 as J
from repro.models.model import build_model as j_build
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.models import rwkv6 as T
from repro_torch.models.model import build_model as t_build
from repro_torch.models.model import init_params as t_init

ATOL = 1e-5
ARCH = "rwkv6_7b"


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


@pytest.fixture(scope="module")
def ssm():
    jcfg, tcfg = _cfgs()
    jm, tm = j_build(jcfg), t_build(tcfg)
    jp = jm.init_params(jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jm, tm, jp, tp, jcfg


def _t(a):
    return torch.as_tensor(np.array(a))


WKV_RTOL = 1e-6


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).detach().float()),
                               np.asarray(want, np.float32), atol=atol, rtol=rtol)


def _close_state(cache, jcache):
    """Every leaf of the recurrent state within ATOL of its largest
    magnitude (at least ATOL)."""
    assert sorted(cache) == sorted(jcache)
    for k in jcache:
        want = np.asarray(jcache[k], np.float32)
        _close(cache[k], want, atol=ATOL * max(1.0, float(np.abs(want).max())))


def _wkv_inputs(seed, B, S, H, K, decay="sigmoid"):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, K)).astype(np.float32) for _ in range(3))
    n = rng.standard_normal((B, S, H, K)).astype(np.float32)
    w = 1 / (1 + np.exp(-(n + 2.0))) if decay == "sigmoid" else np.exp(-np.exp(-6.0 + n / 4))
    u = (rng.standard_normal((H, K)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((B, H, K, K)) * 0.5).astype(np.float32)
    return r, k, v, w.astype(np.float32), u, s0


def _layer(tree, i):
    return jax.tree_util.tree_map(lambda x: x[i], tree)


# ---------------------------------------------------------------------------
# the WKV recurrence, both forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("decay", ["sigmoid", "init"])
def test_wkv_recurrent_matches_jax(carry, decay):
    r, k, v, w, u, s0 = _wkv_inputs(1, 2, 7, 3, 8, decay)
    init = s0 if carry else None
    yj, sj = J._wkv_recurrent(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                              init_state=None if init is None else jnp.asarray(init))
    yt, st = T._wkv_recurrent(*(_t(a) for a in (r, k, v, w, u)), init_state=None if init is None else _t(init))
    _close(yt, yj, rtol=WKV_RTOL)
    _close(st, sj, rtol=WKV_RTOL)


@pytest.mark.parametrize("S,chunk,carry", [(32, 8, False), (50, 16, False), (13, 16, True), (40, 16, True),
                                           (5, 128, False)])
@pytest.mark.parametrize("decay", ["sigmoid", "init"])
def test_wkv_chunked_matches_jax(S, chunk, carry, decay):
    """Chunked WKV: S a multiple of the chunk or not (zero padding at decay
    1), shorter than one chunk, from a zero state or a carried one."""
    r, k, v, w, u, s0 = _wkv_inputs(2, 2, S, 3, 8, decay)
    init = s0 if carry else None
    yj, sj = J._wkv_chunked(*(jnp.asarray(a) for a in (r, k, v, w, u)), chunk,
                            init_state=None if init is None else jnp.asarray(init))
    yt, st = T._wkv_chunked(*(_t(a) for a in (r, k, v, w, u)), chunk, init_state=None if init is None else _t(init))
    assert yt.shape == (2, S, 3, 8) and st.shape == (2, 3, 8, 8)
    _close(yt, yj, rtol=WKV_RTOL)
    _close(st, sj, rtol=WKV_RTOL)


class TestWKV6:
    """``tests/test_models.py::TestWKV6`` on the port, within its 1e-4."""

    def test_chunked_equals_recurrent(self):
        r, k, v, w, u, _ = (_t(a) for a in _wkv_inputs(3, 2, 50, 3, 8))
        y1, s1 = T._wkv_recurrent(r, k, v, w, u)
        y2, s2 = T._wkv_chunked(r, k, v, w, u, chunk=16)
        _close(y2, y1.numpy(), atol=1e-4)
        _close(s2, s1.numpy(), atol=1e-4)

    def test_state_carry(self):
        """Splitting a sequence across two chunked calls == one call."""
        r, k, v, w, u, _ = (_t(a) for a in _wkv_inputs(4, 1, 32, 2, 8))
        y_full, s_full = T._wkv_chunked(r, k, v, w, u, chunk=8)
        y1, s1 = T._wkv_chunked(r[:, :16], k[:, :16], v[:, :16], w[:, :16], u, 8)
        y2, s2 = T._wkv_chunked(r[:, 16:], k[:, 16:], v[:, 16:], w[:, 16:], u, 8, init_state=s1)
        _close(torch.cat([y1, y2], 1), y_full.numpy(), atol=1e-4)
        _close(s2, s_full.numpy(), atol=1e-4)


# ---------------------------------------------------------------------------
# the blocks and the layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,decode,carry", [(1, True, True), (1, True, False), (9, False, False),
                                            (9, False, True), (9, True, True)])
def test_apply_rwkv6_matches_jax(ssm, S, decode, carry):
    """The time mix: one decode token (the exact scan), a prompt (the
    chunked form; with decode=True and S > 1 the JAX package takes it too),
    from a zero or a carried token-shift and WKV state."""
    _, _, jp, tp, cfg = ssm
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    last = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32) if carry else None
    wkv = (rng.standard_normal((2, cfg.n_heads, cfg.head_dim, cfg.head_dim)) * 0.3).astype(np.float32) \
        if carry else None
    oj, (lj, sj) = J.apply_rwkv6(_layer(jp["layers"], 0)["tmix"], jnp.asarray(x), cfg,
                                 last_x=None if last is None else jnp.asarray(last),
                                 wkv_state=None if wkv is None else jnp.asarray(wkv), decode=decode)
    ot, (lt, st) = T.apply_rwkv6(
        {k: v[0] for k, v in tp["layers"]["tmix"].items()}, _t(x), cfg,
        last_x=None if last is None else _t(last), wkv_state=None if wkv is None else _t(wkv), decode=decode)
    _close(ot, oj)
    _close(lt, lj)
    _close(st, sj)


@pytest.mark.parametrize("carry", [False, True])
def test_apply_channel_mix_matches_jax(ssm, carry):
    _, _, jp, tp, cfg = ssm
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 5, cfg.d_model)).astype(np.float32)
    last = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32) if carry else None
    oj, lj = J.apply_channel_mix(_layer(jp["layers"], 1)["cmix"], jnp.asarray(x),
                                 last_x=None if last is None else jnp.asarray(last))
    ot, lt = T.apply_channel_mix({k: v[1] for k, v in tp["layers"]["cmix"].items()}, _t(x),
                                 last_x=None if last is None else _t(last))
    _close(ot, oj)
    _close(lt, lj)


@pytest.mark.parametrize("decode", [False, True])
def test_rwkv_layer_step_matches_jax(ssm, decode):
    jm, tm, jp, tp, cfg = ssm
    rng = np.random.default_rng(7)
    S = 1 if decode else 6
    h = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    states = None
    if decode:
        states = {"last_tm": rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32),
                  "last_cm": rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32),
                  "wkv": (rng.standard_normal((2, cfg.n_heads, cfg.head_dim, cfg.head_dim)) * 0.3)
                  .astype(np.float32)}
    hj, sj = jm._rwkv_layer_step(_layer(jp["layers"], 0), jnp.asarray(h),
                                 states=None if states is None else {k: jnp.asarray(v) for k, v in states.items()},
                                 decode=decode)
    ht, st = tm._rwkv_layer_step(tm._layer(tp, 0)[0], _t(h),
                                 states=None if states is None else {k: _t(v) for k, v in states.items()},
                                 decode=decode)
    _close(ht, hj)
    for k in ("last_tm", "last_cm", "wkv"):
        _close(st[k], sj[k])


# ---------------------------------------------------------------------------
# the tree and the cache
# ---------------------------------------------------------------------------


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


_JDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_matches_jax(dtype):
    """Keys, shapes and dtypes of ``init_params`` equal the JAX tree's
    (``decay_base``, ``bonus_u`` and ``ln_x_scale`` float32 under bf16),
    and the init scales: the constant leaves equal, the normal draws'
    standard deviations near the JAX ones."""
    jcfg, tcfg = (dataclasses.replace(get(ARCH), dtype=dtype) for get in (j_smoke, t_smoke))
    jt = _flat(jax.eval_shape(j_build(jcfg).init_params, jax.random.PRNGKey(0)))
    tt = _flat(t_init(tcfg, torch.Generator().manual_seed(0), device="cpu"))
    assert sorted(jt) == sorted(tt)
    for k, a in jt.items():
        assert tuple(tt[k].shape) == tuple(a.shape), k
        assert tt[k].dtype == _JDT[str(a.dtype)], k
    jv = _flat(j_build(jcfg).init_params(jax.random.PRNGKey(0)))
    for k in ("layers/tmix/decay_base", "layers/tmix/mix_rkvg", "layers/tmix/ln_x_scale", "layers/cmix/mix_k",
              "layers/norm1/scale", "layers/norm2/norm_bias", "final_norm/scale", "final_norm/norm_bias"):
        _close(tt[k].float(), np.asarray(jv[k], np.float32), atol=0)
    for k in ("layers/tmix/w_r", "layers/tmix/ts_lora_b", "layers/tmix/bonus_u", "layers/cmix/w_v", "lm_head"):
        sd_t, sd_j = tt[k].float().std().item(), float(np.asarray(jv[k], np.float32).std())
        assert abs(sd_t - sd_j) < 0.1 * sd_j, (k, sd_t, sd_j)


def test_init_cache_matches_jax(ssm):
    jm, tm, _, _, _ = ssm
    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg = (dataclasses.replace(get(ARCH), dtype=dtype) for get in (j_smoke, t_smoke))
        jc, tc = j_build(jcfg).init_cache(3, 16), t_build(tcfg).init_cache(3, 16, device="cpu")
        assert sorted(jc) == sorted(tc)
        for k in jc:
            assert tuple(tc[k].shape) == jc[k].shape and tc[k].dtype == _JDT[str(jc[k].dtype)], k
            assert not tc[k].any()


# ---------------------------------------------------------------------------
# decode and prefill
# ---------------------------------------------------------------------------


def _random_state(cfg, B, seed):
    rng = np.random.default_rng(seed)
    n, d, H, K = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim
    return {"last_tm": rng.standard_normal((n, B, 1, d)).astype(np.float32),
            "last_cm": rng.standard_normal((n, B, 1, d)).astype(np.float32),
            "wkv": (rng.standard_normal((n, B, H, K, K)) * 0.3).astype(np.float32)}


@pytest.mark.parametrize("use_kernels", [False, True])
def test_decode_step_matches_jax(ssm, use_kernels):
    """A batched decode step from a carried state: logits and every state
    leaf (the port writes them into the cache in place).  The kernel route
    sends the final LayerNorm to the layernorm kernel (its plain version
    here; the JAX package's Pallas kernel in interpret mode)."""
    jm, tm, jp, tp, cfg = ssm
    state = _random_state(cfg, 3, 8)
    toks = np.array([[5], [9], [33]])
    lg_j, jc = jm.decode_step(jp, {k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(toks), 4,
                              use_pallas=use_kernels)
    tc = {k: _t(v).clone() for k, v in state.items()}
    lg_t, tc2 = tm.decode_step(tp, tc, _t(toks), 4, use_kernels=use_kernels)
    assert tc2 is tc
    _close(lg_t, lg_j)
    _close_state(tc, jc)


def test_decode_step_per_lane_equals_batched(ssm):
    """Each lane stepped alone on a view of its row (as the serving prefill
    steps it) gives the batched step's logits and state: no op couples
    lanes."""
    _, tm, _, tp, cfg = ssm
    state = _random_state(cfg, 3, 9)
    toks = np.array([[5], [9], [33]])
    tc = {k: _t(v).clone() for k, v in state.items()}
    lg, _ = tm.decode_step(tp, tc, _t(toks), 0)
    for i in range(3):
        full = {k: _t(v).clone() for k, v in state.items()}
        row = {k: v[:, i:i + 1] for k, v in full.items()}
        lg1, _ = tm.decode_step(tp, row, _t(toks[i:i + 1]), 0)
        _close(lg1[0], lg[i].numpy())
        for k in tc:
            _close(full[k][:, i], tc[k][:, i].numpy())


@pytest.mark.parametrize("S", [7, 24])
def test_prefill_matches_jax(ssm, S):
    """Prefill runs the chunked WKV from a zero state whatever the cache
    holds, as the JAX package's does, and leaves the state after the
    prompt in the cache."""
    jm, tm, jp, tp, cfg = ssm
    toks = np.random.default_rng(10).integers(0, cfg.vocab_size, (2, S))
    stale = _random_state(cfg, 2, 11)
    lg_j, jc = jm.prefill(jp, jnp.asarray(toks), {k: jnp.asarray(v) for k, v in stale.items()})
    tc = {k: _t(v).clone() for k, v in stale.items()}
    lg_t, tc = tm.prefill(tp, _t(toks), tc)
    assert lg_t.shape == (2, 1, cfg.vocab_size)
    _close(lg_t, lg_j)
    _close_state(tc, jc)


def test_decode_consistency(ssm):
    """``tests/test_models.py::test_decode_consistency`` for rwkv6 on the
    port: prefill(prompt) and decode_step(token) logits against the JAX
    full forward at the same positions (2e-2, as there), and against the
    JAX prefill and decode_step (1e-5)."""
    jm, tm, jp, tp, cfg = ssm
    B, S = 2, 24
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (B, S), 0, cfg.vocab_size))
    full = jm.apply_train(jp, {"tokens": jnp.asarray(tokens)}).logits
    jc = jm.init_cache(B, 64)
    lg_pj, jc = jm.prefill(jp, jnp.asarray(tokens[:, :S - 1]), jc)
    lg_dj, jc = jm.decode_step(jp, jc, jnp.asarray(tokens[:, S - 1:]), S - 1)
    tc = tm.init_cache(B, 64, device="cpu")
    lg_p, tc = tm.prefill(tp, _t(tokens[:, :S - 1]), tc)
    _close(lg_p[:, 0], full[:, S - 2], atol=2e-2)
    lg_d, tc = tm.decode_step(tp, tc, _t(tokens[:, S - 1:]), S - 1)
    _close(lg_d[:, 0], full[:, S - 1], atol=2e-2)
    _close(lg_p, lg_pj)
    _close(lg_d, lg_dj)
    _close_state(tc, jc)


def test_ssm_refuses_exit_and_spec(ssm):
    """Per-token exit, speculative decode and the token-exit forward do not
    exist for the ssm family in the JAX package (it asserts); the port
    raises ValueError.  Its training forward is ported (held against the
    JAX package in ``test_torch_train_forwards.py``)."""
    _, tm, _, tp, cfg = ssm
    cache = tm.init_cache(1, 8, device="cpu")
    tok = torch.tensor([[3]])
    with pytest.raises(ValueError, match="per-token exit"):
        tm.decode_step_ee(tp, cache, tok, 0, 1.0)
    with pytest.raises(ValueError, match="per-token exit"):
        tm.decode_step_spec(tp, cache, tok, 0, 1.0, 2)
    with pytest.raises(ValueError, match="token exit"):
        tm.forward_token_exit(tp, np.zeros((1, 4), np.int64), 1.0)
    assert tm.apply_train(tp, {"tokens": np.zeros((1, 4), np.int64)}).logits.shape == (1, 4, cfg.vocab_size)
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="ssm decoder"):
        t_build(dataclasses.replace(tcfg, tie_embeddings=True))
    # activation quantization is accepted (tests/test_torch_eb_decoders.py); shared layers are not
    qcfg = tcfg.with_edgebert(quant=dataclasses.replace(tcfg.edgebert.quant, enabled=True))
    assert t_build(qcfg).cfg.edgebert.quant.enabled and "layers" in t_init(qcfg, device="cpu")
    with pytest.raises(ValueError, match="ssm decoder"):
        t_build(dataclasses.replace(tcfg, shared_layers=True))

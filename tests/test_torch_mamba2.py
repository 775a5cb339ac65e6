"""The hybrid family (zamba2: Mamba2 SSD blocks and the shared attention
block), port against the JAX package.

The smoke ``zamba2_1p2b`` config (4 Mamba2 blocks, d_model 64, d_inner 128,
8 SSD heads of 16, state 16, chunk 32; the shared block after blocks 2 and
4 at width 128, 4 heads of 32; vocab 512) in float32; the JAX package
initialises the params, the weight bridge carries them across, and every
other input is made by numpy from a seed.  The decay rates of the SSD tests
are the init's, -exp(log(linspace(1, 16, H))), and dt is softplus of a
normal draw, as the block makes them.

Tolerances: atol 1e-5 on SSD outputs and states, logits and caches between
the packages, with rtol 1e-6 beside it on the SSD outputs and states (they
reach 28 in magnitude, where 1e-5 is a few float32 ulps); the mixer's and
the blocks' outputs and states within 1e-5 of their largest magnitude (the
mixer's output sums SSD outputs of that size through w_out and reaches 4);
the model's decode state (conv, SSM state and the shared block's K/V after
a prefill or a decode step) within 1e-5 of its leaf's largest magnitude;
1e-4 for the chunked SSD against the one-token recurrence inside the port,
as the JAX package holds its own (``tests/test_models.py::TestSSD``), and
for the chunked prefill against one-token decode steps, each leaf relative
to its largest magnitude; 2e-2 for prefill and decode against the full
forward, as ``test_decode_consistency`` holds the JAX package.  The
chunked form's ``cumsum`` within a chunk is a difference of large numbers
at decay rates up to 16; at chunk 32 and these prompt lengths the two
packages' sums stay within the tolerances above.  A batched decode step
equals one-lane steps within 1e-5 (GEMMs at another M may round
differently).  ``a_log`` equals the JAX init within 1e-6: XLA's CPU
``log`` and ``linspace`` are not correctly rounded.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as j_smoke
from repro.models import mamba2 as J
from repro.models.model import build_model as j_build
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config as t_config
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.models import mamba2 as T
from repro_torch.models.model import build_model as t_build
from repro_torch.models.model import init_params as t_init

ATOL = 1e-5
SSD_RTOL = 1e-6
ARCH = "zamba2_1p2b"


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
def hyb():
    jcfg, tcfg = _cfgs()
    jm, tm = j_build(jcfg), t_build(tcfg)
    jp = jm.init_params(jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jm, tm, jp, tp, jcfg


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).detach().float()),
                               np.asarray(want, np.float32), atol=atol, rtol=rtol)


def _close_mag(got, want, rel=ATOL):
    """Within ``rel`` of the largest magnitude of ``want`` (at least rel)."""
    want = np.asarray(want, np.float32)
    _close(got, want, atol=rel * max(1.0, float(np.abs(want).max())))


def _close_state(cache, jcache, rel=ATOL):
    """Every leaf within ``rel`` of its largest magnitude (at least rel)."""
    assert sorted(cache) == sorted(jcache)
    for k in jcache:
        _close_mag(cache[k], jcache[k], rel)


def _layer(tree, i):
    return jax.tree_util.tree_map(lambda x: x[i], tree)


def _ssd_inputs(seed, B, S, H, P, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    a = (-np.linspace(1.0, 16.0, H)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, N)).astype(np.float32) for _ in range(2))
    s0 = (rng.standard_normal((B, H, P, N)) * 0.5).astype(np.float32)
    return x, dt, a, Bm, Cm, s0


# ---------------------------------------------------------------------------
# the SSD, both forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,chunk,carry", [(32, 8, False), (45, 16, False), (13, 16, True), (40, 16, True),
                                           (5, 32, False)])
def test_ssd_chunked_matches_jax(S, chunk, carry):
    """Chunked SSD: S a multiple of the chunk or not (zero padding),
    shorter than one chunk, from a zero state or a carried one."""
    x, dt, a, Bm, Cm, s0 = _ssd_inputs(1, 2, S, 3, 4, 5)
    init = s0 if carry else None
    yj, sj = J._ssd_chunked(*(jnp.asarray(v) for v in (x, dt, a, Bm, Cm)), chunk,
                            init_state=None if init is None else jnp.asarray(init))
    yt, st = T._ssd_chunked(*(_t(v) for v in (x, dt, a, Bm, Cm)), chunk, init_state=None if init is None else _t(init))
    assert yt.shape == (2, S, 3, 4) and st.shape == (2, 3, 4, 5)
    _close(yt, yj, rtol=SSD_RTOL)
    _close(st, sj, rtol=SSD_RTOL)


def test_ssd_step_matches_jax():
    x, dt, a, Bm, Cm, s0 = _ssd_inputs(2, 3, 1, 4, 8, 6)
    sj, yj = J._ssd_step(*(jnp.asarray(v) for v in (s0, x[:, 0], dt[:, 0], a, Bm[:, 0], Cm[:, 0])))
    st, yt = T._ssd_step(*(_t(v) for v in (s0, x[:, 0], dt[:, 0], a, Bm[:, 0], Cm[:, 0])))
    _close(yt, yj, rtol=SSD_RTOL)
    _close(st, sj, rtol=SSD_RTOL)


def test_ssd_upper_triangle_overflow_stays_finite():
    """At decay rate 16 and dt ~ 5 the upper triangle's exp(seg) overflows
    to inf; ``where`` chooses it away, so no inf * 0 turns into NaN."""
    x, dt, a, Bm, Cm, _ = _ssd_inputs(3, 1, 32, 2, 4, 4)
    dt = np.full_like(dt, 5.0)
    yt, st = T._ssd_chunked(*(_t(v) for v in (x, dt, a, Bm, Cm)), 32)
    assert torch.isfinite(yt).all() and torch.isfinite(st).all()
    yj, _ = J._ssd_chunked(*(jnp.asarray(v) for v in (x, dt, a, Bm, Cm)), 32)
    _close(yt, yj, rtol=SSD_RTOL)


class TestSSD:
    """``tests/test_models.py::TestSSD`` on the port, within its 1e-4."""

    def test_chunked_equals_stepwise(self):
        rng = np.random.default_rng(5)
        B, S, H, P, N = 2, 29, 3, 8, 6
        x = _t(rng.standard_normal((B, S, H, P)).astype(np.float32))
        dt = torch.nn.functional.softplus(_t(rng.standard_normal((B, S, H)).astype(np.float32)))
        a = -torch.exp(_t(rng.standard_normal(H).astype(np.float32)) * 0.3)
        Bm, Cm = (_t(rng.standard_normal((B, S, N)).astype(np.float32)) for _ in range(2))
        y1, f1 = T._ssd_chunked(x, dt, a, Bm, Cm, chunk=8)
        st = torch.zeros((B, H, P, N))
        ys = []
        for t in range(S):
            st, y = T._ssd_step(st, x[:, t], dt[:, t], a, Bm[:, t], Cm[:, t])
            ys.append(y)
        _close(y1, torch.stack(ys, 1).numpy(), atol=1e-4)
        _close(f1, st.numpy(), atol=1e-4)


# ---------------------------------------------------------------------------
# the mixer and the blocks
# ---------------------------------------------------------------------------


def _mixer_state(cfg, B, seed):
    rng = np.random.default_rng(seed)
    conv = rng.standard_normal((B, T.CONV_K - 1, T.d_inner(cfg) + 2 * cfg.ssm_state)).astype(np.float32)
    ssm = (rng.standard_normal((B, T.n_ssm_heads(cfg), cfg.ssm_head_dim, cfg.ssm_state)) * 0.5).astype(np.float32)
    return conv, ssm


@pytest.mark.parametrize("S,decode,carry", [(1, True, True), (9, False, False), (40, False, True),
                                            (5, True, True), (2, False, False)])
def test_apply_mamba2_matches_jax(hyb, S, decode, carry):
    """The mixer: one decode token (the recurrence), a prompt (the chunked
    form over one or two chunks; with decode=True and S > 1 the JAX
    package takes it too, after the conv state), from a zero or a carried
    SSM state; with 2 tokens the conv state is None in both."""
    _, tm, jp, tp, cfg = hyb
    x = np.random.default_rng(6).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    conv, ssm = _mixer_state(cfg, 2, 7)
    kw_j = dict(conv_state=jnp.asarray(conv) if decode else None, ssm_state=jnp.asarray(ssm) if carry else None)
    kw_t = dict(conv_state=_t(conv) if decode else None, ssm_state=_t(ssm) if carry else None)
    oj, (cj, sj) = J.apply_mamba2(_layer(jp["layers"], 1)["mixer"], jnp.asarray(x), cfg, decode=decode, **kw_j)
    ot, (ct, st) = T.apply_mamba2(tm._layer(tp, 1)[0]["mixer"], _t(x), cfg, decode=decode, **kw_t)
    _close_mag(ot, oj)
    assert (cj is None) == (ct is None)
    if cj is not None:
        _close(ct, cj)
    _close_mag(st, sj)


@pytest.mark.parametrize("decode", [False, True])
def test_mamba_block_step_matches_jax(hyb, decode):
    jm, tm, jp, tp, cfg = hyb
    S = 1 if decode else 6
    h = np.random.default_rng(8).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    conv, ssm = _mixer_state(cfg, 2, 9)
    hj, sj = jm._mamba_block_step(_layer(jp["layers"], 0), jnp.asarray(h),
                                  states={"conv": jnp.asarray(conv), "ssm": jnp.asarray(ssm)} if decode else None,
                                  decode=decode)
    ht, st = tm._mamba_block_step(tm._layer(tp, 0)[0], _t(h),
                                  states={"conv": _t(conv), "ssm": _t(ssm)} if decode else None, decode=decode)
    _close_mag(ht, hj)
    for k in ("conv", "ssm"):
        _close_mag(st[k], sj[k])


@pytest.mark.parametrize("cached", [False, True])
def test_shared_attn_step_matches_jax(hyb, cached):
    """The shared block on concat(h, x0): a prompt with a cache written from
    position 0, or one token at a scalar position against a filled cache
    (the JAX package's one-lane call), rotary positions at width 2 d."""
    jm, tm, jp, tp, cfg = hyb
    rng = np.random.default_rng(10)
    S = 1 if cached else 5
    h, x0 = (rng.standard_normal((2, S, cfg.d_model)).astype(np.float32) for _ in range(2))
    ck, cv = (rng.standard_normal((2, 16, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32) for _ in range(2))
    pos = 7 if cached else 0
    positions = np.arange(S) + pos
    hj, (kj, vj) = jm._shared_attn_step(jp["shared_attn"], jnp.asarray(h), jnp.asarray(x0),
                                        cache=(jnp.asarray(ck), jnp.asarray(cv)), cache_pos=pos,
                                        positions=jnp.asarray(positions))
    kt, vt = _t(ck), _t(cv)
    ht = tm._shared_attn_step(tp["shared_attn"], _t(h), _t(x0), cache=(kt, vt), cache_pos=pos,
                              positions=_t(positions))
    _close(ht, hj)
    _close(kt, kj)
    _close(vt, vj)


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
    (``a_log``, ``dt_bias`` and ``d_skip`` float32 under bf16), and the init
    scales: the constant leaves equal, the normal draws' standard
    deviations near the JAX ones."""
    jcfg, tcfg = (dataclasses.replace(get(ARCH), dtype=dtype) for get in (j_smoke, t_smoke))
    jt = _flat(jax.eval_shape(j_build(jcfg).init_params, jax.random.PRNGKey(0)))
    tt = _flat(t_init(tcfg, torch.Generator().manual_seed(0), device="cpu"))
    assert sorted(jt) == sorted(tt)
    for k, a in jt.items():
        assert tuple(tt[k].shape) == tuple(a.shape), k
        assert tt[k].dtype == _JDT[str(a.dtype)], k
    jv = _flat(j_build(jcfg).init_params(jax.random.PRNGKey(0)))
    for k in ("layers/mixer/dt_bias", "layers/mixer/d_skip", "layers/norm/scale", "shared_attn/norm1/scale",
              "shared_attn/norm2/scale", "final_norm/scale"):
        _close(tt[k].float(), np.asarray(jv[k], np.float32), atol=0)
    _close(tt["layers/mixer/a_log"], np.asarray(jv["layers/mixer/a_log"]), atol=1e-6)
    for k in ("layers/mixer/w_in", "layers/mixer/conv_w", "layers/mixer/w_out", "shared_attn/attn/wq",
              "shared_attn/attn/wo", "shared_attn/mlp/w_down", "shared_attn/out_proj", "embed/tok", "lm_head"):
        sd_t, sd_j = tt[k].float().std().item(), float(np.asarray(jv[k], np.float32).std())
        assert abs(sd_t - sd_j) < 0.1 * sd_j, (k, sd_t, sd_j)


def test_full_config_is_the_published_one():
    """zamba2-1.2b field for field: 38 blocks of d_model 2048 (d_inner 4096,
    64 SSD heads of 64, state 64, chunk 128), the shared block every 6
    blocks (6 calls) at width 4096 with 32 x 128 heads and d_ff 8192."""
    cfg = t_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size) == (
        38, 2048, 32, 128, 8192, 32000)
    assert (T.d_inner(cfg), T.n_ssm_heads(cfg), cfg.ssm_state, cfg.ssm_chunk, cfg.attn_every) == (
        4096, 64, 64, 128, 6)
    assert cfg.n_layers // cfg.attn_every == 6 and 2 * cfg.d_model == cfg.n_heads * cfg.head_dim


def test_init_cache_matches_jax():
    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg = (dataclasses.replace(get(ARCH), dtype=dtype) for get in (j_smoke, t_smoke))
        jc, tc = j_build(jcfg).init_cache(3, 16), t_build(tcfg).init_cache(3, 16, device="cpu")
        assert sorted(jc) == sorted(tc) == ["conv", "k", "ssm", "v"]
        for k in jc:
            assert tuple(tc[k].shape) == jc[k].shape and tc[k].dtype == _JDT[str(jc[k].dtype)], k
            assert not tc[k].any()


# ---------------------------------------------------------------------------
# decode and prefill
# ---------------------------------------------------------------------------


def _filled(jm, jp, cfg, B, S, seed):
    """A JAX cache after a prefill of S random tokens."""
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))
    _, jc = jm.prefill(jp, jnp.asarray(toks), jm.init_cache(B, 48))
    return jc


def _tcache(jc):
    return {k: _t(v).clone() for k, v in jc.items()}


@pytest.mark.parametrize("use_kernels", [False, True])
def test_decode_step_matches_jax(hyb, use_kernels):
    """A batched decode step after a prefill: logits and every cache leaf
    (written in place).  The kernel route changes nothing: no norm of the
    family reaches the layernorm kernel (they are RMS)."""
    jm, tm, jp, tp, cfg = hyb
    jc = _filled(jm, jp, cfg, 3, 8, 11)
    toks = np.array([[5], [9], [33]])
    lg_j, jc2 = jm.decode_step(jp, jc, jnp.asarray(toks), 8, use_pallas=use_kernels)
    tc = _tcache(jc)
    calls = []
    real = tdispatch.layernorm
    tdispatch.layernorm = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        lg_t, tc2 = tm.decode_step(tp, tc, _t(toks), 8, use_kernels=use_kernels)
    finally:
        tdispatch.layernorm = real
    assert tc2 is tc and not calls
    _close(lg_t, lg_j)
    _close_state(tc, jc2)


def test_decode_step_per_lane_positions(hyb):
    """Lanes at their own positions in one batched call: each lane equals
    the JAX package's one-lane call at its scalar position, and the port's
    own one-lane call on a view of its row."""
    jm, tm, jp, tp, cfg = hyb
    jc = _filled(jm, jp, cfg, 3, 12, 12)
    toks = np.array([[5], [9], [33]])
    pos = np.array([3, 8, 12])
    tc = _tcache(jc)
    lg, _ = tm.decode_step(tp, tc, _t(toks), _t(pos))
    for i in range(3):
        ji = jax.tree_util.tree_map(lambda x: x[:, i:i + 1], jc)
        lg_j, ji2 = jm.decode_step(jp, ji, jnp.asarray(toks[i:i + 1]), int(pos[i]))
        _close(lg[i], np.asarray(lg_j)[0])
        _close_state({k: v[:, i:i + 1] for k, v in tc.items()}, ji2)
        row = {k: v[:, i:i + 1] for k, v in _tcache(jc).items()}
        lg1, _ = tm.decode_step(tp, row, _t(toks[i:i + 1]), int(pos[i]))
        _close(lg1[0], lg[i].numpy())
        for k in tc:
            _close_mag(row[k][:, 0], tc[k][:, i].numpy())


@pytest.mark.parametrize("S", [7, 40])
def test_prefill_matches_jax(hyb, S):
    """Prefill runs the chunked SSD from a zero state whatever the cache
    holds (one chunk, or two with padding), writes the conv state (the last
    3 raw rows), the SSM state and the shared block's K/V."""
    jm, tm, jp, tp, cfg = hyb
    toks = np.random.default_rng(13).integers(0, cfg.vocab_size, (2, S))
    stale = _filled(jm, jp, cfg, 2, 5, 14)
    lg_j, jc = jm.prefill(jp, jnp.asarray(toks), stale)
    lg_t, tc = tm.prefill(tp, _t(toks), _tcache(stale))
    assert lg_t.shape == (2, 1, cfg.vocab_size)
    _close(lg_t, lg_j)
    _close_state(tc, jc)


def test_prefill_refuses_prompts_under_three_tokens(hyb):
    """The JAX package's prefill fails on a prompt of fewer than 3 tokens
    (the conv state is None); the port raises ValueError."""
    _, tm, _, tp, cfg = hyb
    for S in (1, 2):
        with pytest.raises(ValueError, match="3 prompt tokens"):
            tm.prefill(tp, torch.zeros((1, S), dtype=torch.long), tm.init_cache(1, 8, device="cpu"))


def test_chunked_prefill_equals_one_token_steps(hyb):
    """``Model.prefill`` (the chunked SSD) of a prompt from a fresh cache
    against the serving prefill's one-token decode steps over the same
    prompt: last-token logits and every state leaf within 1e-4 of its
    largest magnitude."""
    _, tm, _, tp, cfg = hyb
    toks = np.random.default_rng(15).integers(0, cfg.vocab_size, (1, 20))
    lg_p, cp = tm.prefill(tp, _t(toks), tm.init_cache(1, 32, device="cpu"))
    cs = tm.init_cache(1, 32, device="cpu")
    for t in range(toks.shape[1]):
        lg_s, cs = tm.decode_step(tp, cs, _t(toks[:, t:t + 1]), t)
    _close(lg_p[:, 0], lg_s[:, 0].numpy(), atol=1e-4)
    _close_state(cp, {k: v.numpy() for k, v in cs.items()}, rel=1e-4)


def test_decode_consistency(hyb):
    """``tests/test_models.py::test_decode_consistency`` for zamba2 on the
    port: prefill(prompt) and decode_step(token) logits against the JAX
    full forward at the same positions (2e-2, as there), and against the
    JAX prefill and decode_step (1e-5)."""
    jm, tm, jp, tp, cfg = hyb
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


def test_hybrid_refuses_exit_and_spec(hyb):
    """Per-token exit, speculative decode and the token-exit forward do not
    exist for the hybrid family in the JAX package (it asserts); the port
    raises ValueError.  Its training forward is ported (held against the
    JAX package in ``test_torch_train_forwards.py``)."""
    _, tm, _, tp, cfg = hyb
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
    with pytest.raises(ValueError, match="hybrid decoder"):
        t_build(dataclasses.replace(tcfg, norm="layernorm"))
    # adaptive spans are accepted (on the shared block: tests/test_torch_eb_decoders.py); a tied head is not
    scfg = tcfg.with_edgebert(span=dataclasses.replace(tcfg.edgebert.span, enabled=True))
    assert t_build(scfg).cfg.edgebert.span.enabled and "span_z" in t_init(scfg, device="cpu")
    with pytest.raises(ValueError, match="hybrid decoder"):
        t_build(dataclasses.replace(tcfg, tie_embeddings=True))

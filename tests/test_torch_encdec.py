"""The encoder-decoder family (whisper), port against the JAX package, at
model level: ``init_cache`` -> ``prefill(aux={"enc_input": frames})`` ->
``decode_step``, the contract the JAX package's own
``test_decode_consistency`` holds.

The smoke ``whisper_medium`` config (2 encoder and 2 decoder layers,
d_model 64, 4 heads of 16, d_ff 128, 32 frames, vocab 512) in float32; the
JAX package initialises the params, the weight bridge carries them across,
and the frames and every other input are made by numpy from a seed (the
frames scaled by 0.1, as the JAX tests scale theirs: the conv frontend is a
stub in both packages).

Tolerances: atol 1e-5 on attention outputs, encoder outputs, logits and
caches between the packages (float32 sums in another order); 2e-2 for
prefill and decode against the full forward, as ``test_decode_consistency``
holds the JAX package.  A batched decode step at per-lane positions equals
the JAX package's one-lane calls within 1e-5.

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
from repro.models import layers as JL
from repro.models.model import build_model as j_build
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config as t_config
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.launch import serve
from repro_torch.models import layers as TL
from repro_torch.models.model import build_model as t_build
from repro_torch.models.model import init_params as t_init
from repro_torch.serving.engine import DecoderServer

ATOL = 1e-5
ARCH = "whisper_medium"


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
def ed():
    jcfg, tcfg = _cfgs()
    jm, tm = j_build(jcfg), t_build(tcfg)
    jp = jm.init_params(jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jm, tm, jp, tp, jcfg


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).detach().float()),
                               np.asarray(want, np.float32), atol=atol, rtol=0)


def _close_cache(cache, jcache):
    assert sorted(cache) == sorted(jcache)
    for k in jcache:
        _close(cache[k], jcache[k])


def _layer(tree, i):
    return jax.tree_util.tree_map(lambda x: x[i], tree)


def _frames(cfg, B, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, cfg.enc_seq_len, cfg.d_model)) * 0.1).astype(np.float32)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _prefilled(ed, B=2, S=9, seed=3):
    """The JAX prefill of S tokens over seeded frames, and the port's from
    the same inputs: (JAX logits, JAX cache, port logits, port cache)."""
    jm, tm, jp, tp, cfg = ed
    frames, toks = _frames(cfg, B, seed), _tokens(cfg, B, S, seed + 1)
    lg_j, jc = jm.prefill(jp, jnp.asarray(toks), jm.init_cache(B, 32), aux={"enc_input": jnp.asarray(frames)})
    lg_t, tc = tm.prefill(tp, _t(toks), tm.init_cache(B, 32, device="cpu"), aux={"enc_input": _t(frames)})
    return lg_j, jc, lg_t, tc


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Sq", [1, 7, 20])
def test_attention_layer_kv_source_matches_jax(ed, Sq):
    """Cross-attention: keys and values projected from another input, no
    positions, no causal mask, no cache (the short path and the chunked
    one on the query side)."""
    _, _, jp, tp, cfg = ed
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, Sq, cfg.d_model)).astype(np.float32)
    src = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    oj, cj = JL.attention_layer(_layer(jp["dec_cross"], 0)["xattn"], jnp.asarray(x), cfg, causal=False,
                                kv_source=jnp.asarray(src))
    ot = TL.attention_layer({k: v[0] for k, v in tp["dec_cross"]["xattn"].items()}, _t(x), cfg, causal=False,
                            kv_source=_t(src))
    assert cj is None and ot.shape == (2, Sq, cfg.d_model)
    _close(ot, oj)
    with pytest.raises(ValueError, match="no cache"):
        TL.attention_layer({k: v[0] for k, v in tp["dec_cross"]["xattn"].items()}, _t(x), cfg, causal=False,
                           kv_source=_t(src), cache=(torch.zeros(2, 8, 4, 16), torch.zeros(2, 8, 4, 16)),
                           cache_pos=0)


def test_encode_matches_jax(ed):
    """The encoder: learned positions, pre-LN non-causal layers, the final
    norm."""
    jm, tm, jp, tp, cfg = ed
    frames = _frames(cfg, 2, 5)
    _close(tm._encode(tp, _t(frames)), jm._encode(jp, jnp.asarray(frames)))


def test_precomputed_cross_matches_jax(ed):
    jm, tm, jp, tp, cfg = ed
    rng = np.random.default_rng(6)
    h = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    ek, ev = (rng.standard_normal((3, cfg.enc_seq_len, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
              for _ in range(2))
    oj = jm._precomputed_cross(_layer(jp["dec_cross"], 1), jnp.asarray(h), jnp.asarray(ek), jnp.asarray(ev))
    ot = tm._precomputed_cross(tm._layer(tp, 1, "dec_cross")[0], _t(h), _t(ek), _t(ev))
    _close(ot, oj)


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
    """Keys, shapes and dtypes of ``init_params`` equal the JAX tree's (the
    learned position tables, the encoder's layers, ``enc_norm`` and the
    decoder's cross-attention), and the init scales."""
    jcfg, tcfg = (dataclasses.replace(get(ARCH), dtype=dtype) for get in (j_smoke, t_smoke))
    jt = _flat(jax.eval_shape(j_build(jcfg).init_params, jax.random.PRNGKey(0)))
    tt = _flat(t_init(tcfg, torch.Generator().manual_seed(0), device="cpu"))
    assert sorted(jt) == sorted(tt)
    for k, a in jt.items():
        assert tuple(tt[k].shape) == tuple(a.shape), k
        assert tt[k].dtype == _JDT[str(a.dtype)], k
    jv = _flat(j_build(jcfg).init_params(jax.random.PRNGKey(0)))
    for k in ("enc_norm/scale", "enc_norm/norm_bias", "dec_cross/norm/scale", "enc_layers/norm1/norm_bias",
              "final_norm/scale"):
        _close(tt[k].float(), np.asarray(jv[k], np.float32), atol=0)
    for k in ("embed/pos", "enc_pos", "enc_layers/attn/wq", "enc_layers/mlp/w_down", "dec_cross/xattn/wk",
              "layers/mlp/w_up", "lm_head"):
        sd_t, sd_j = tt[k].float().std().item(), float(np.asarray(jv[k], np.float32).std())
        assert abs(sd_t - sd_j) < 0.1 * sd_j, (k, sd_t, sd_j)


def test_full_config_is_the_published_one():
    """whisper-medium field for field: 24 + 24 layers of d_model 1024,
    16 x 64 heads, d_ff 4096, vocab 51865, 1500 frames, and the learned
    position table at the default max_seq_len (524288 rows), kept as the
    JAX config keeps it."""
    cfg = t_config(ARCH)
    assert (cfg.n_layers, cfg.n_enc_layers, cfg.enc_seq_len, cfg.d_model, cfg.n_heads, cfg.head_dim) == (
        24, 24, 1500, 1024, 16, 64)
    assert (cfg.d_ff, cfg.vocab_size, cfg.act, cfg.norm, cfg.pos, cfg.max_seq_len) == (
        4096, 51865, "gelu", "layernorm", "learned", 524288)


def test_init_cache_matches_jax():
    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg = (dataclasses.replace(get(ARCH), dtype=dtype) for get in (j_smoke, t_smoke))
        jc, tc = j_build(jcfg).init_cache(3, 16), t_build(tcfg).init_cache(3, 16, device="cpu")
        assert sorted(jc) == sorted(tc) == ["enc_k", "enc_v", "k", "v"]
        for k in jc:
            assert tuple(tc[k].shape) == jc[k].shape and tc[k].dtype == _JDT[str(jc[k].dtype)], k
            assert not tc[k].any()


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------


def test_prefill_matches_jax(ed):
    """The prefill encodes the frames once, writes every layer's cross K/V
    and the decoder's K/V at 0..S-1; last-token logits."""
    lg_j, jc, lg_t, tc = _prefilled(ed)
    assert lg_t.shape == (2, 1, ed[4].vocab_size)
    _close(lg_t, lg_j)
    _close_cache(tc, jc)


def test_prefill_needs_the_encoder_input(ed):
    _, tm, _, tp, cfg = ed
    for aux in (None, {}, {"image_embeds": torch.zeros(1)}):
        with pytest.raises(ValueError, match="enc_input"):
            tm.prefill(tp, torch.zeros((1, 4), dtype=torch.long), tm.init_cache(1, 8, device="cpu"), aux=aux)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_decode_step_matches_jax(ed, use_kernels):
    """A batched decode step after the prefill: logits and every cache leaf
    (the decoder's K/V written in place, the cross K/V read)."""
    jm, tm, jp, tp, _ = ed
    _, jc, _, tc = _prefilled(ed)
    toks = np.array([[5], [9]])
    lg_j, jc = jm.decode_step(jp, jc, jnp.asarray(toks), 9, use_pallas=use_kernels)
    lg_t, tc2 = tm.decode_step(tp, tc, _t(toks), 9, use_kernels=use_kernels)
    assert tc2 is tc
    _close(lg_t, lg_j)
    _close_cache(tc, jc)


def test_decode_step_per_lane_positions(ed):
    """Lanes at their own positions in one call (learned positions and the
    K/V write per lane): each lane equals the JAX package's one-lane call
    at its scalar position."""
    jm, tm, jp, tp, cfg = ed
    _, jc, _, _ = _prefilled(ed, B=3, S=12)
    toks = np.array([[5], [9], [33]])
    pos = np.array([4, 9, 12])
    tc = {k: _t(v).clone() for k, v in jc.items()}
    lg, _ = tm.decode_step(tp, tc, _t(toks), _t(pos))
    for i in range(3):
        ji = jax.tree_util.tree_map(lambda x: x[:, i:i + 1], jc)
        lg_j, ji2 = jm.decode_step(jp, ji, jnp.asarray(toks[i:i + 1]), int(pos[i]))
        _close(lg[i], np.asarray(lg_j)[0])
        _close_cache({k: v[:, i:i + 1] for k, v in tc.items()}, ji2)


def test_the_encoder_input_reaches_the_output(ed):
    """Frames from another seed change the prefill's and a decode step's
    logits (the decoder does attend the encoder)."""
    _, tm, _, tp, cfg = ed
    toks = _tokens(cfg, 2, 9, 7)
    outs = []
    for seed in (1, 2):
        cache = tm.init_cache(2, 32, device="cpu")
        lg_p, cache = tm.prefill(tp, _t(toks), cache, aux={"enc_input": _t(_frames(cfg, 2, seed))})
        lg_d, _ = tm.decode_step(tp, cache, _t(toks[:, -1:]), 9)
        outs.append((lg_p, lg_d))
    assert (outs[0][0] - outs[1][0]).abs().max() > 1e-3
    assert (outs[0][1] - outs[1][1]).abs().max() > 1e-3


def test_only_the_decode_steps_final_norm_takes_the_kernel(ed):
    """The calls reaching ``dispatch.layernorm``: one per ``decode_step``
    with ``use_kernels`` (its final norm), none without it, none in the
    prefill (the encoder, the layers' and the cross norms take no flag in
    the JAX package)."""
    _, tm, _, tp, cfg = ed
    calls = []
    real = tdispatch.layernorm
    tdispatch.layernorm = lambda *a, **k: calls.append(a[0].shape) or real(*a, **k)
    try:
        cache = tm.init_cache(2, 32, device="cpu")
        tm.prefill(tp, _t(_tokens(cfg, 2, 6, 8)), cache, aux={"enc_input": _t(_frames(cfg, 2, 8))})
        assert calls == []
        for t in range(3):
            tm.decode_step(tp, cache, torch.tensor([[3], [4]]), 6 + t, use_kernels=True)
        assert calls == [torch.Size([2, 1, cfg.d_model])] * 3
        tm.decode_step(tp, cache, torch.tensor([[3], [4]]), 9)
        assert len(calls) == 3
    finally:
        tdispatch.layernorm = real


def test_decode_consistency(ed):
    """``tests/test_models.py::test_decode_consistency`` for whisper on the
    port: prefill(prompt, frames) and decode_step(token) logits against the
    JAX full forward at the same positions (2e-2, as there), and against
    the JAX prefill and decode_step (1e-5)."""
    jm, tm, jp, tp, cfg = ed
    B, S = 2, 24
    rng = jax.random.PRNGKey(2)
    tokens = np.asarray(jax.random.randint(rng, (B, S), 0, cfg.vocab_size))
    frames = np.asarray(jax.random.normal(rng, (B, cfg.enc_seq_len, cfg.d_model)) * 0.1)
    full = jm.apply_train(jp, {"tokens": jnp.asarray(tokens), "enc_input": jnp.asarray(frames)}).logits
    jc = jm.init_cache(B, 64)
    lg_pj, jc = jm.prefill(jp, jnp.asarray(tokens[:, :S - 1]), jc, aux={"enc_input": jnp.asarray(frames)})
    lg_dj, jc = jm.decode_step(jp, jc, jnp.asarray(tokens[:, S - 1:]), S - 1)
    tc = tm.init_cache(B, 64, device="cpu")
    lg_p, tc = tm.prefill(tp, _t(tokens[:, :S - 1]), tc, aux={"enc_input": _t(frames)})
    _close(lg_p[:, 0], full[:, S - 2], atol=2e-2)
    lg_d, tc = tm.decode_step(tp, tc, _t(tokens[:, S - 1:]), S - 1)
    _close(lg_d[:, 0], full[:, S - 1], atol=2e-2)
    _close(lg_p, lg_pj)
    _close(lg_d, lg_dj)
    _close_cache(tc, jc)


def test_encdec_refusals(ed):
    """Per-token exit, speculative decode and the token-exit forward do not
    exist for the family in the JAX package (it asserts): ValueError, and
    the DecoderServer and the launcher refuse exit for it.  The training
    forward and the server are ported (``test_torch_train_forwards.py``,
    ``test_torch_decoder_families_server.py``): the server serves the
    family in plain decode, as the JAX server does."""
    _, tm, _, tp, cfg = ed
    cache = tm.init_cache(1, 8, device="cpu")
    tok = torch.tensor([[3]])
    with pytest.raises(ValueError, match="per-token exit"):
        tm.decode_step_ee(tp, cache, tok, 0, 1.0)
    with pytest.raises(ValueError, match="per-token exit"):
        tm.decode_step_spec(tp, cache, tok, 0, 1.0, 2)
    with pytest.raises(ValueError, match="token exit"):
        tm.forward_token_exit(tp, np.zeros((1, 4), np.int64), 1.0)
    with pytest.raises(ValueError, match="enc_input"):
        tm.apply_train(tp, {"tokens": np.zeros((1, 4), np.int64)})
    with pytest.raises(ValueError, match="encdec family has no per-token exit"):
        DecoderServer(tm, tp, device="cpu", exit_threshold=1.0)
    assert DecoderServer(tm, tp, device="cpu").model is tm
    with pytest.raises(ValueError, match="no per-token exit"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--threshold", "1.0"])
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="encoder-decoder"):
        t_build(dataclasses.replace(tcfg, act="swiglu"))
    with pytest.raises(ValueError, match="encoder-decoder"):
        t_build(dataclasses.replace(tcfg, n_enc_layers=0))

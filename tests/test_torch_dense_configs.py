"""The dense decoder configs beyond deepseek-7b, port against the JAX
package: minitron-8b (LayerNorm, squared-ReLU MLP, GQA 32 / 8),
internlm2-20b (RMS norm, rope_theta 1e6, GQA 48 / 8) and qwen1.5-110b (qkv
biases, rope_theta 1e6, GQA 64 / 8).

Each smoke config in float32; the JAX package initialises the params, the
norms' scales and biases and the qkv biases are then drawn away from their
init (ones and zeros) by numpy from a seed, so that a LayerNorm's gamma and
beta and the biases take part, and the weight bridge carries the tree
across.

Tolerances: atol 1e-5 on logits, hidden states, caches and entropies
(float32 sums in another order); exit layers, tokens and accept masks
equal.  The kernel route (``use_kernels=True``) runs the plain versions on
the CPU and the JAX package's Pallas kernels in interpret mode; which norms
take it is checked by counting the calls that reach
``dispatch.layernorm``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_config
from repro.configs.base import get_smoke_config as j_smoke
from repro.kernels import dispatch as jdispatch
from repro.models import layers as JL
from repro.models.model import build_model as j_build
from repro.serving import step_math as jsm
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import PORTED_ARCHS, jax_fields
from repro_torch.configs.base import get_config as t_config
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.models import layers as TL
from repro_torch.models.model import build_model as t_build
from repro_torch.models.model import init_params as t_init
from repro_torch.serving import step_math as tsm

ATOL = 1e-5
ARCHS = ("minitron_8b", "internlm2_20b", "qwen1_5_110b")
NEW_ARCHS = ARCHS + ("rwkv6_7b",)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module (see test_torch_decode.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


def _cfgs(arch, **kw):
    return tuple(dataclasses.replace(get(arch), dtype="float32", remat_policy="none", **kw)
                 for get in (j_smoke, t_smoke))


_MODELS = {}


def _models(arch):
    """(jax model, port model, jax params, port params, cfg), the norms and
    qkv biases drawn away from their init."""
    if arch not in _MODELS:
        jcfg, tcfg = _cfgs(arch)
        jm, tm = j_build(jcfg), t_build(tcfg)
        tree = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.PRNGKey(1)))
        r = _rng(100)
        layers = tree["layers"]
        for norm in (layers["norm1"], layers["norm2"], tree["final_norm"]):
            norm["scale"] = (1.0 + 0.2 * r.standard_normal(norm["scale"].shape)).astype(np.float32)
            if "norm_bias" in norm:
                norm["norm_bias"] = (0.1 * r.standard_normal(norm["norm_bias"].shape)).astype(np.float32)
        for b in ("bq", "bk", "bv"):
            if b in layers["attn"]:
                layers["attn"][b] = (0.5 * r.standard_normal(layers["attn"][b].shape)).astype(np.float32)
        jp = jax.tree_util.tree_map(jnp.asarray, tree)
        _MODELS[arch] = (jm, tm, jp, params_from_numpy(tree, device="cpu"), jcfg)
    return _MODELS[arch]


def _filled_jcache(cfg, B, S, seed):
    r = _rng(seed)
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
    return {k: jnp.asarray(r.standard_normal(shape).astype(np.float32)) for k in ("k", "v")}


def _tcache(jcache):
    return {k: _t(v) for k, v in jcache.items()}


# ---------------------------------------------------------------------------
# configs and layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_equals_jax(arch):
    """The published config and the smoke config, field for field."""
    assert arch in PORTED_ARCHS
    for get_j, get_t in ((j_config, t_config), (j_smoke, t_smoke)):
        assert jax_fields(get_t(arch)) == dataclasses.asdict(get_j(arch))


def test_published_widths():
    rows = {a: (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.head_dim, c.d_ff, c.vocab_size, c.act, c.norm)
            for a in NEW_ARCHS for c in (t_config(a),)}
    assert rows == {
        "minitron_8b": (32, 4096, 32, 8, 128, 16384, 256000, "relu2", "layernorm"),
        "internlm2_20b": (48, 6144, 48, 8, 128, 16384, 92544, "swiglu", "rms"),
        "qwen1_5_110b": (80, 8192, 64, 8, 128, 49152, 152064, "swiglu", "rms"),
        "rwkv6_7b": (32, 4096, 64, 64, 64, 14336, 65536, "relu2", "layernorm"),
    }
    assert t_config("qwen1_5_110b").qkv_bias and t_config("internlm2_20b").rope_theta == 1e6


def test_relu2_mlp():
    """The squared ReLU in fp32 and cast back, no gate, on minitron-8b's
    two-matrix MLP."""
    jm, tm, jp, tp, cfg = _models("minitron_8b")
    x = _rng(2).standard_normal((2, 3, cfg.d_model)).astype(np.float32)
    lp_j = jax.tree_util.tree_map(lambda a: a[1], jp["layers"]["mlp"])
    lp_t = {k: v[1] for k, v in tp["layers"]["mlp"].items()}
    assert sorted(lp_t) == ["w_down", "w_up"]
    _close(TL.apply_mlp(lp_t, _t(x), act="relu2"), JL.apply_mlp(lp_j, jnp.asarray(x), "relu2"))


def test_layernorm_with_bias():
    r = _rng(3)
    x = r.standard_normal((3, 5, 64)).astype(np.float32) * 3.0
    p = {"scale": (1.0 + 0.1 * r.standard_normal(64)).astype(np.float32),
         "norm_bias": (0.1 * r.standard_normal(64)).astype(np.float32)}
    want = JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), "layernorm")
    tp = {k: _t(v) for k, v in p.items()}
    _close(TL.apply_norm(tp, _t(x), kind="layernorm"), want)
    _close(TL.apply_norm(tp, _t(x), kind="layernorm", use_kernels=True), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_jax(arch):
    """Keys, shapes and dtypes of ``init_params`` (bf16 as published, the
    LayerNorm decoder's ``norm_bias``, qwen1.5's zero qkv biases) equal the
    JAX tree's."""
    jcfg, tcfg = (get(arch) for get in (j_smoke, t_smoke))
    want = jax.eval_shape(j_build(jcfg).init_params, jax.random.PRNGKey(0))
    got = t_init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert (jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)), want)
            == jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")), got))
    if tcfg.qkv_bias:
        assert not got["layers"]["attn"]["bq"].any()
    if tcfg.norm == "layernorm":
        assert not got["final_norm"]["norm_bias"].any() and (got["layers"]["norm1"]["scale"] == 1).all()


# ---------------------------------------------------------------------------
# the decode methods
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step(arch, use_kernels):
    jm, tm, jp, tp, cfg = _models(arch)
    jc = _filled_jcache(cfg, 2, 16, 6)
    tc = _tcache(jc)
    toks = np.array([[5], [9]])
    for pos in (0, 3, 15):
        lg_j, jc = jm.decode_step(jp, jc, jnp.asarray(toks), pos, use_pallas=use_kernels)
        lg_t, tc = tm.decode_step(tp, tc, _t(toks), pos, use_kernels=use_kernels)
        _close(lg_t, lg_j)
        for k in ("k", "v"):
            _close(tc[k], jc[k])


@pytest.mark.parametrize("threshold", [-1.0, "mid", np.inf])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_ee(arch, threshold):
    """Per-lane positions as the serving step runs them, against the JAX
    package's lane vmap, both routes: logits, exits, first entropies and
    the cache."""
    jm, tm, jp, tp, cfg = _models(arch)
    jc = _filled_jcache(cfg, 4, 16, 7)
    toks = np.array([[5], [9], [300], [41]])
    pos = np.array([0, 3, 9, 15], np.int32)
    if threshold == "mid":
        _, _, _, fe = jsm.decoder_decode_ee(jm, jp, jc, jnp.asarray(toks), jnp.asarray(pos), -1.0)
        threshold = float(np.median(np.asarray(fe)))
    lg_j, jc2, xl_j, fe_j = jsm.decoder_decode_ee(jm, jp, jc, jnp.asarray(toks), jnp.asarray(pos), threshold,
                                                  use_pallas=True)
    for use_kernels in (False, True):
        tc = _tcache(jc)
        lg_t, tc, xl_t, fe_t = tsm.decoder_decode_ee(tm, tp, tc, _t(toks), _t(pos), threshold,
                                                     use_kernels=use_kernels)
        np.testing.assert_array_equal(xl_t.numpy(), np.asarray(xl_j))
        _close(lg_t, lg_j)
        _close(fe_t, fe_j)
        for k in ("k", "v"):
            _close(tc[k], jc2[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_spec(arch):
    """Self-speculative step over 3 lanes, W = 3, a threshold row per lane,
    against step_math.decoder_decode_spec."""
    jm, tm, jp, tp, cfg = _models(arch)
    jc = _filled_jcache(cfg, 3, 16, 9)
    toks = np.array([[5], [9], [300]])
    pos = np.array([2, 7, 13], np.int32)
    _, _, _, fe = jsm.decoder_decode_ee(jm, jp, jc, jnp.asarray(toks), jnp.asarray(pos), -1.0)
    base = float(np.quantile(np.asarray(fe), 0.9))
    thr = (base + np.array([[0.0, 0.0, 0.0], [0.002, -0.001, 0.0], [0.01, 0.01, 0.01]])).astype(np.float32)
    want = jsm.decoder_decode_spec(jm, jp, jc, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(thr), 3,
                                   use_pallas=True)
    got = tsm.decoder_decode_spec(tm, tp, _tcache(jc), _t(toks), _t(pos), _t(thr), 3, use_kernels=True)
    for i in (0, 3, 5):                                # tokens, exits, accepted
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    _close(got[1], want[1])
    _close(got[4], want[4])
    for k in ("k", "v"):
        _close(got[2][k], want[2][k])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_serving_prefill(arch):
    """Model.prefill over a batch, and the serving prefill of one lane
    (prompt[:length - 1] through full-depth decode steps on the kernel
    route), which leaves the other lanes untouched."""
    jm, tm, jp, tp, cfg = _models(arch)
    toks = _rng(11).integers(4, cfg.vocab_size, (2, 20))
    jc = _filled_jcache(cfg, 2, 24, 12)
    lg_j, jc2 = jm.prefill(jp, jnp.asarray(toks), jc)
    lg_t, tc = tm.prefill(tp, _t(toks), _tcache(jc))
    _close(lg_t, lg_j)
    for k in ("k", "v"):
        _close(tc[k], jc2[k])
    jc = _filled_jcache(cfg, 3, 16, 13)
    prompt = np.zeros(16, np.int32)
    prompt[:7] = _rng(14).integers(4, cfg.vocab_size, 7)
    want = jsm.decoder_prefill(jm, jp, jc, jnp.asarray(prompt), jnp.int32(1), jnp.int32(7), 3, use_pallas=True)
    got = tsm.decoder_prefill(tm, tp, _tcache(jc), prompt, 1, 7, use_kernels=True)
    for k in ("k", "v"):
        _close(got[k], want[k])
        np.testing.assert_array_equal(got[k][:, [0, 2]].numpy(), np.asarray(jc[k])[:, [0, 2]])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_token_exit(arch):
    jm, tm, jp, tp, cfg = _models(arch)
    toks = _rng(10).integers(4, cfg.vocab_size, (2, 20))
    lg0, _ = jm.forward_token_exit(jp, jnp.asarray(toks), -1.0)
    mid = float(np.median(np.asarray(jdispatch.entropy(lg0))))
    for thr in (-1.0, mid, np.inf):
        lg_j, xl_j = jm.forward_token_exit(jp, jnp.asarray(toks), thr)
        lg_t, xl_t = tm.forward_token_exit(tp, _t(toks), thr)
        np.testing.assert_array_equal(xl_t.numpy(), np.asarray(xl_j))
        _close(lg_t, lg_j)


# ---------------------------------------------------------------------------
# which norms take the layernorm kernel
# ---------------------------------------------------------------------------


def _count_layernorm(monkeypatch):
    calls = []
    real = tdispatch.layernorm

    def counting(x, scale, bias, *, eps=1e-6):
        calls.append(tuple(x.shape))
        return real(x, scale, bias, eps=eps)

    monkeypatch.setattr(tdispatch, "layernorm", counting)
    return calls


@pytest.mark.parametrize("arch,per_step,per_ee_step", [("minitron_8b", "2n+1", "3n"), ("internlm2_20b", "0", "0"),
                                                       ("qwen1_5_110b", "0", "0"), ("rwkv6_7b", "1", None)])
def test_kernel_route_takes_the_reference_norms(arch, per_step, per_ee_step, monkeypatch):
    """The kernel route reaches ``dispatch.layernorm`` where the JAX
    package passes ``use_pallas``: both pre-norms of every layer and the
    final norm (2n + 1 per decode step, 3n per early-exit step, whose
    off-ramp after every layer takes the final norm) for the LayerNorm
    decoder; never for an RMS norm; the final norm alone for rwkv6 (its
    per-layer LayerNorms take no flag in the JAX package).  The reference
    route reaches it never; the serving prefill of an L-token prompt takes
    L - 1 decode steps."""
    if arch == "rwkv6_7b":
        jcfg, tcfg = _cfgs(arch)
        tm = t_build(tcfg)
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, j_build(jcfg).init_params(
            jax.random.PRNGKey(1))), device="cpu")
    else:
        _, tm, _, tp, tcfg = _models(arch)
    n = tcfg.n_layers
    want_step = {"2n+1": 2 * n + 1, "3n": 3 * n, "0": 0, "1": 1}
    calls = _count_layernorm(monkeypatch)
    cache = tm.init_cache(4, 16, device="cpu")
    toks, pos = _t(np.array([[5], [9], [300], [41]])), _t(np.array([0, 3, 9, 15]))
    tm.decode_step(tp, cache, toks, pos)
    assert calls == []
    tm.decode_step(tp, cache, toks, pos, use_kernels=True)
    assert len(calls) == want_step[per_step] and all(c == (4, 1, tcfg.d_model) for c in calls)
    prompt = np.zeros(16, np.int32)
    prompt[:6] = np.arange(6) + 4
    calls.clear()
    tsm.decoder_prefill(tm, tp, cache, prompt, 2, 6, use_kernels=True)
    assert len(calls) == 5 * want_step[per_step]
    if per_ee_step is not None:
        calls.clear()
        tm.decode_step_ee(tp, cache, toks, pos, 0.5, use_kernels=True)
        assert len(calls) == want_step[per_ee_step]

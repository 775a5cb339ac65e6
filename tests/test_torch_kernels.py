"""The port's kernels against the JAX package's Pallas kernels.

On the CPU every wrapper takes its plain PyTorch version, which is held
against the Pallas kernel run in interpret mode (as tests/test_kernels.py
runs it).  tests/test_torch_cuda.py holds each CUDA kernel against its
plain version on the card; it imports no JAX, so it runs where JAX is absent.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.adaptivfloat import AFFormat as JAFFormat
from repro.core.adaptivfloat import af_encode as j_af_encode
from repro.kernels import ops as jops
from repro.kernels.adaptivfloat_k import af_matmul as j_af_matmul
from repro.kernels.layernorm import layernorm as j_layernorm
from repro.kernels.softmax_entropy import softmax_entropy as j_softmax_entropy
from repro.kernels.span_attention import span_attention as j_span_attention
from repro_torch.core.adaptivfloat import af_encode
from repro_torch.kernels import ops
from repro_torch.kernels.adaptivfloat_k import af_matmul
from repro_torch.kernels.layernorm import layernorm
from repro_torch.kernels.softmax_entropy import softmax_entropy
from repro_torch.kernels.span_attention import span_attention


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# Tolerances: both sides compute in float32 with the same formulas; they
# differ only in the order of sums and in last-ulp exp/log/rsqrt, so the
# bounds are a few float32 ulps of the values' magnitude.


@pytest.mark.parametrize("rows,d", [(4, 8), (100, 128), (257, 96), (1, 512)])
def test_layernorm_matches_pallas(rows, d):
    """atol 1e-5 on unit-scale outputs (inputs of scale 3)."""
    x, g, b = _np((rows, d), 1, 3.0), _np((d,), 2), _np((d,), 3)
    want = np.asarray(j_layernorm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), block_rows=64))
    got = layernorm(_t(x), _t(g), _t(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("rows,n", [(3, 4), (100, 64), (130, 3), (16, 3)])
def test_softmax_entropy_matches_pallas(rows, n):
    """Probs and entropy within 1e-6 (probs <= 1, entropy <= log n), with a
    mask that zeroes ~30% of the probs."""
    x = _np((rows, n), 4, 5.0)
    mask = (np.random.default_rng(5).random((rows, n)) > 0.3).astype(np.float32)
    jp, jh = j_softmax_entropy(jnp.asarray(x), jnp.asarray(mask), block_rows=32)
    tp, th = softmax_entropy(_t(x), _t(mask))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-6)
    assert (tp.numpy()[mask == 0] == 0).all()


def test_softmax_entropy_op_without_mask():
    x = _np((2, 5, 3), 6, 3.0)
    jp, jh = jops.softmax_entropy_op(jnp.asarray(x))
    tp, th = ops.softmax_entropy_op(_t(x))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-6)


@pytest.mark.parametrize("m,k,n", [(16, 32, 16), (70, 96, 50), (128, 128, 128), (33, 130, 67), (3, 768 // 8, 3)])
def test_af_matmul_matches_pallas(m, k, n):
    """rtol 1e-5 / atol 1e-5 on unit-scale outputs (weights at the model's
    1/sqrt(fan_in) init scale): the decode is exact on both sides (the codes
    are equal), so only the float32 summation order differs.  Ragged M/K/N
    exercise the Pallas padding against the port's masking."""
    w = _np((k, n), 7, 1.0 / np.sqrt(k))
    x = _np((m, k), 8)
    jcodes, je = j_af_encode(jnp.asarray(w), JAFFormat())
    codes, e_min = af_encode(_t(w))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    want = np.asarray(j_af_matmul(jnp.asarray(x), jcodes, je, bm=32, bk=32, bn=32))
    got = af_matmul(_t(x), codes, int(e_min)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("BH,S,dh,window", [(2, 64, 8, 16), (8, 100, 16, 37), (4, 128, 64, 64)])
def test_span_attention_matches_pallas(causal, BH, S, dh, window):
    """atol 2e-5 (the tolerance tests/test_kernels.py holds the Pallas
    kernel to against its oracle); window < S, so the kernel skips tiles."""
    q, k, v = _np((BH, S, dh), 11), _np((BH, S, dh), 12), _np((BH, S, dh), 13)
    spans = np.random.default_rng(14).integers(1, window + 1, BH).astype(np.int32)
    want = np.asarray(j_span_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(spans), window,
        causal=causal, bq=32, bk=32,
    ))
    got = span_attention(_t(q), _t(k), _t(v), _t(spans), window, causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_span_attention_kv_lens_matches_pallas(causal):
    BH, S, dh, window = 4, 64, 8, 64
    q, k, v = _np((BH, S, dh), 23), _np((BH, S, dh), 24), _np((BH, S, dh), 25)
    spans = np.full(BH, window, np.int32)
    lens = np.asarray([23, 64, 1, 40], np.int32)
    want = np.asarray(j_span_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(spans), window,
        causal=causal, bq=32, bk=32, kv_lens=jnp.asarray(lens),
    ))
    got = span_attention(_t(q), _t(k), _t(v), _t(spans), window, causal=causal, kv_lens=_t(lens))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_span_attention_op_gathers_dead_heads(causal):
    """The deploy path with paper Table I QQP-like spans (8/12 heads off) and
    grouped KV heads, through both packages' ops."""
    B, S, H, KV, dh = 2, 128, 12, 6, 16
    q, k, v = _np((B, S, H, dh), 15), _np((B, S, KV, dh), 16), _np((B, S, KV, dh), 17)
    spans = [16, 0, 0, 0, 0, 0, 40, 75, 0, 0, 0, 2]
    want = np.asarray(jops.span_attention_op(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), spans, causal=causal, bq=64, bk=64,
    ))
    got = ops.span_attention_op(_t(q), _t(k), _t(v), spans, causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    dead = [i for i, s in enumerate(spans) if s == 0]
    assert (got[:, :, dead] == 0).all()


def test_span_attention_op_all_heads_off():
    B, S, H, dh = 1, 32, 4, 8
    q, k, v = (_t(_np((B, S, H, dh), s)) for s in (18, 19, 20))
    out = ops.span_attention_op(q, k, v, [0, 0, 0, 0], causal=True)
    assert out.shape == q.shape and (out == 0).all()


def test_launch_counts_only_move_on_the_card():
    """CPU tensors take the plain versions, which launch nothing."""
    ops.reset_launch_counts()
    x = _t(_np((4, 8), 21))
    layernorm(x, torch.ones(8), torch.zeros(8))
    softmax_entropy(x)
    assert all(n == 0 for n in ops.launch_counts().values())

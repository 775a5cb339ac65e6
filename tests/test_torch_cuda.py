"""The port's CUDA kernels on the card, each against its plain version.

Every test needs an NVIDIA GPU and nvcc and skips elsewhere.  The file
imports no JAX (the plain versions are held against the JAX package in
test_torch_kernels.py), so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.core.adaptivfloat import af_encode
from repro_torch.kernels import ops, ref
from repro_torch.kernels.adaptivfloat_k import af_matmul
from repro_torch.kernels.layernorm import layernorm
from repro_torch.kernels.softmax_entropy import softmax_entropy
from repro_torch.kernels.span_attention import span_attention
from repro_torch.models.model import init_params
from repro_torch.serving.deploy import deploy_albert

pytestmark = pytest.mark.cuda


def _t(shape, seed, scale=1.0):
    return torch.from_numpy((np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from repro_torch.common.device import resolve_device

    return resolve_device("cuda")


def test_layernorm(cuda):
    """atol 1e-5 on unit-scale outputs: sum order and rsqrtf's last ulp."""
    x, g, b = _t((2048, 768), 1, 3.0).to(cuda), _t((768,), 2).to(cuda), _t((768,), 3).to(cuda)
    before = layernorm.launches
    got = layernorm(x, g, b)
    assert layernorm.launches == before + 1
    torch.testing.assert_close(got, ref.layernorm(x, g, b), atol=1e-5, rtol=0)


def test_softmax_entropy(cuda):
    """atol 1e-6: probs <= 1 and entropies <= log n, last-ulp expf/logf."""
    x = _t((130, 3), 4, 5.0).to(cuda)
    mask = torch.from_numpy((np.random.default_rng(5).random((130, 3)) > 0.3).astype(np.float32)).to(cuda)
    for m in (None, mask):
        p, h = softmax_entropy(x, m)
        rp, rh = ref.softmax_entropy(x, m)
        torch.testing.assert_close(p, rp, atol=1e-6, rtol=0)
        torch.testing.assert_close(h, rh, atol=1e-6, rtol=0)


@pytest.mark.parametrize("m,k,n", [(2048, 768, 3072), (2048, 3072, 768), (33, 130, 67), (16, 768, 3)])
def test_af_matmul(cuda, m, k, n):
    """rtol/atol 1e-5 on unit-scale outputs: the decode is exact, so only the
    float32 summation order differs from the plain version's cuBLAS call."""
    codes, e_min = af_encode(_t((k, n), 7, 1.0 / np.sqrt(k)))
    x, codes = _t((m, k), 8).to(cuda), codes.to(cuda)
    got = af_matmul(x, codes, int(e_min))
    torch.testing.assert_close(got, ref.af_matmul(x, codes, int(e_min)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("BH,S,dh,window", [(192, 128, 64, 64), (8, 100, 16, 37), (4, 200, 128, 200)])
def test_span_attention(cuda, causal, BH, S, dh, window):
    """atol 2e-5, as the Pallas kernel is held to its oracle; spans include
    0 (rows of zeros) and kv_lens mask right padding."""
    q, k, v = (_t((BH, S, dh), s) for s in (11, 12, 13))
    spans = torch.from_numpy(np.random.default_rng(14).integers(0, window + 1, BH).astype(np.int32))
    lens = torch.from_numpy(np.random.default_rng(15).integers(1, S + 1, BH).astype(np.int32))
    for kv in (None, lens):
        want = span_attention(q, k, v, spans, window, causal=causal, kv_lens=kv)
        got = span_attention(q.to(cuda), k.to(cuda), v.to(cuda), spans.to(cuda), window,
                             causal=causal, kv_lens=None if kv is None else kv.to(cuda))
        torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=0)


def test_wrappers_raise_instead_of_falling_back(cuda):
    x = _t((4, 8), 21).to(cuda)
    with pytest.raises(TypeError):
        layernorm(x.double(), torch.ones(8, device=cuda, dtype=torch.float64),
                  torch.zeros(8, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        layernorm(x, torch.ones(8), torch.zeros(8))       # gamma on the CPU


def test_deployed_classify_matches_cpu(cuda):
    """Smoke-size deploy on the card against the same deploy on the CPU
    (plain versions), full depth: exits equal, logits atol 1e-4."""
    cfg = get_smoke_config("albert_edgebert")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 32))
    cpu = deploy_albert(params, cfg, device="cpu")
    gpu = deploy_albert(params, cfg, device=cuda)
    cpu.threshold = gpu.threshold = 0.0
    ops.reset_launch_counts()
    lg, eg = gpu.classify(tokens)
    assert all(n > 0 for n in ops.launch_counts().values())
    lc, ec = cpu.classify(tokens)
    np.testing.assert_array_equal(eg, ec)
    np.testing.assert_allclose(lg, lc, atol=1e-4)

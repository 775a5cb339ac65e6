"""The port's CUDA kernels on the card, each against its plain version.

Every test needs an NVIDIA GPU and nvcc and skips elsewhere.  The file
imports no JAX (the plain versions are held against the JAX package in
test_torch_kernels.py), so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports JAX.)
"""
import numpy as np
import pytest
import torch

import dataclasses

from repro_torch.configs.base import get_smoke_config
from repro_torch.core.adaptivfloat import af_encode
from repro_torch.core.pruning import magnitude_mask
from repro_torch.data.synthetic import SyntheticCLS
from repro_torch.kernels import block_sparse, dispatch, ops, ref
from repro_torch.kernels.adaptivfloat_k import (
    af_matmul,
    group_exp_bias,
    quantize,
    quantize_groups,
)
from repro_torch.kernels.layernorm import layernorm
from repro_torch.kernels.softmax_entropy import entropy, offramp_head, softmax_entropy
from repro_torch.kernels.span_attention import span_attention, span_attention_heads
from repro_torch.models.model import build_model, init_params
from repro_torch.serving.deploy import deploy_albert
from repro_torch.serving.engine import ClassifierServer, DecoderServer, Request

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


@pytest.mark.parametrize("rows,d", [(37, 64), (301, 100), (1025, 768), (259, 3072), (1, 768), (513, 640),
                                    (97, 896)])
def test_layernorm_widths(cuda, rows, d):
    """atol 1e-5 at every width: the generic path (d = 64, 100, 3072), the
    register-resident float4 rows (d = 128 * 1..8: 640, 768, 896), ragged
    row counts that leave warps of the last block idle."""
    x, g, b = _t((rows, d), 6, 3.0).to(cuda), _t((d,), 7).to(cuda), _t((d,), 8).to(cuda)
    torch.testing.assert_close(layernorm(x, g, b), ref.layernorm(x, g, b), atol=1e-5, rtol=0)


def test_softmax_entropy(cuda):
    """atol 1e-6: probs <= 1 and entropies <= log n, last-ulp expf/logf."""
    x = _t((130, 3), 4, 5.0).to(cuda)
    mask = torch.from_numpy((np.random.default_rng(5).random((130, 3)) > 0.3).astype(np.float32)).to(cuda)
    for m in (None, mask):
        p, h = softmax_entropy(x, m)
        rp, rh = ref.softmax_entropy(x, m)
        torch.testing.assert_close(p, rp, atol=1e-6, rtol=0)
        torch.testing.assert_close(h, rh, atol=1e-6, rtol=0)


@pytest.mark.parametrize("m,k,n", [(2048, 768, 3072), (2048, 3072, 768), (33, 130, 67), (16, 768, 3),
                                   (128, 768, 768), (512, 3072, 768), (16, 768, 768),
                                   (2048, 128, 768)])
def test_af_matmul(cuda, m, k, n):
    """rtol/atol 1e-5 on unit-scale outputs: the decode and the bf16 split
    are exact, so only the float32 summation order differs from the plain
    version's cuBLAS call.  The encoder's shapes, the split-K route (M = 128,
    512, 16), the off-ramp (768 x 3), the embed projection (128 x 768) and
    unaligned rows (K = 130, N = 67)."""
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


@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_span_attention_strided_heads(cuda, dh, causal):
    """[B, S, H, dh] operands read through permuted views and the result
    written into a permuted view of a [B, S, H, dh] tensor; kv_len below one
    32-key tile, on a tile edge (32, 64), ragged S; atol 2e-5 against the
    plain version on contiguous copies."""
    B, S, H = 3, 100, 4
    q, k, v = (_t((B, S, H, dh), s) for s in (51, 52, 53))
    spans = torch.tensor([64, 3, 100, 0], dtype=torch.int32)
    lens = torch.tensor([5, 32, 64], dtype=torch.int32)
    flat = [x.permute(0, 2, 1, 3).reshape(B * H, S, dh).contiguous() for x in (q, k, v)]
    want = span_attention(*flat, spans.repeat(B), 100, causal=causal, kv_lens=lens.repeat_interleave(H))
    out = torch.full((B, S, H, dh), float("nan"), device=cuda)
    got = span_attention_heads(*(x.to(cuda).permute(0, 2, 1, 3) for x in (q, k, v)), spans.to(cuda), 100,
                               causal=causal, kv_lens=lens.to(cuda), out=out.permute(0, 2, 1, 3))
    assert got.data_ptr() == out.data_ptr()
    torch.testing.assert_close(out.permute(0, 2, 1, 3).reshape(B * H, S, dh).cpu(), want, atol=2e-5, rtol=0)
    # repeated launches give the same bits
    again = span_attention_heads(*(x.to(cuda).permute(0, 2, 1, 3) for x in (q, k, v)), spans.to(cuda), 100,
                                 causal=causal, kv_lens=lens.to(cuda))
    assert torch.equal(again, out.permute(0, 2, 1, 3))


@pytest.mark.parametrize("rows,n", [(4, 102400), (1, 102400), (8, 102400), (4, 151936), (1, 151936), (3, 1001),
                                    (37, 512), (1000, 3), (2, 32003), (5, 32000), (300, 4096), (1, 1)])
def test_entropy_wide_rows(cuda, rows, n):
    """The decode path's wide-row entry against the plain version, atol
    1e-5: sums of up to 102400 terms in another order (a cluster of up to
    8 blocks per row; float4 loads where n % 4 == 0, scalar otherwise), and
    one launch counted per call."""
    x = (_t((rows, n), 30 + rows, 1.3) + _t((rows, 1), 31, 3.0)).to(cuda)
    before = softmax_entropy.launches
    got = entropy(x)
    assert softmax_entropy.launches == before + 1
    torch.testing.assert_close(got, ref.softmax_entropy(x)[1], atol=1e-5, rtol=0)


def test_entropy_wide_rows_deterministic_and_routed(cuda):
    """Two launches on the same logits give the same bits (the triples merge
    in a fixed order); dispatch.entropy takes [lanes, 1, V] through it; it
    refuses what it does not take instead of falling back."""
    x = _t((4, 102400), 32, 1.3).to(cuda)
    assert torch.equal(entropy(x), entropy(x))
    lg = x[:, None, :]
    before = softmax_entropy.launches
    got = dispatch.entropy(lg)
    assert softmax_entropy.launches == before + 1 and got.shape == (4, 1)
    torch.testing.assert_close(got[:, 0], ref.softmax_entropy(x)[1], atol=1e-5, rtol=0)
    with pytest.raises(TypeError):
        entropy(x.to(torch.bfloat16))
    with pytest.raises(ValueError):
        entropy(x.t())
    with pytest.raises(ValueError):
        entropy(x[None])


def test_entropy_wide_rows_at_qwen_vocab_repeatable(cuda):
    """The MoE decoder's LM-head entropy at vocabulary 151936 (a cluster of
    8 blocks per row, 16-byte loads): two launches give the same bits."""
    for rows in (4, 1):
        x = _t((rows, 151936), 33 + rows, 1.3).to(cuda)
        assert torch.equal(entropy(x), entropy(x))


def _moe_smoke(seed=0):
    """The smoke qwen2-moe config in float32 with random nonzero qkv biases
    (the init zeroes them), on the CPU."""
    cfg = dataclasses.replace(get_smoke_config("qwen2_moe_a2p7b"), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for name in ("bq", "bk", "bv"):
        b = params["layers"]["attn"][name]
        b.copy_(0.5 * torch.randn(b.shape, generator=g))
    return cfg, build_model(cfg), params


@pytest.mark.parametrize("lanes", [4, 8])
def test_moe_decoder_server_matches_cpu(cuda, lanes):
    """The smoke MoE decoder drain on the card against the same on the CPU,
    at 4 lanes and at 8 (where the prefill steps every lane): at full
    depth, with every token exiting at layer 1, and at spec window 4;
    tokens and exits equal, final logits atol 1e-4, softmax_entropy
    launched n_layers x W times per fused step."""
    cfg, model, params = _moe_smoke()
    prompts = [np.random.default_rng(i).integers(4, cfg.vocab_size, 4 + i % 6) for i in range(10)]
    for thr, W in ((-1.0, 1), (1e9, 1), (1e9, 4)):
        out = {}
        for dev in ("cpu", cuda):
            srv = DecoderServer(model, params, batch_lanes=lanes, max_seq=32, eos_id=-1, buckets=(16,),
                                exit_threshold=thr, spec_window=W, device=dev)
            for i, p in enumerate(prompts):
                srv.submit(Request(uid=i, tokens=p, max_new_tokens=4))
            ops.reset_launch_counts()
            st = srv.run()
            out[str(dev)] = (srv, ops.launch_counts(), st)
        (cpu, _, _), (gpu, launches, st) = out["cpu"], out[str(cuda)]
        assert launches["softmax_entropy"] == cfg.n_layers * W * st["decode_steps"]
        assert all(launches[k] > 0 for k in ops.MOE_DECODE_KERNELS)
        for i in range(len(prompts)):
            assert gpu.done[i].generated == cpu.done[i].generated
            assert gpu.done[i].token_exit_layers == cpu.done[i].token_exit_layers
            np.testing.assert_allclose(gpu.done[i].result, cpu.done[i].result, atol=1e-4)


def test_moe_spec_window_four_equals_one_bitwise_on_card(cuda):
    """On the card, 4 lanes, per-token exit at the probe's median: W = 4's
    tokens, exits and final logits equal W = 1's bit for bit (per-lane
    routing, the combine without atomics)."""
    from repro_torch.serving.engine import probe_exit_threshold

    cfg, model, params = _moe_smoke()
    prompts = [np.random.default_rng(i).integers(4, cfg.vocab_size, 4 + i % 5) for i in range(8)]
    thr = probe_exit_threshold(model, params, prompts, batch_lanes=4, max_new_tokens=4, device=cuda)
    done = {}
    for W in (1, 4):
        srv = DecoderServer(model, params, batch_lanes=4, max_seq=32, eos_id=-1, buckets=(16,),
                            exit_threshold=thr, spec_window=W, device=cuda)
        for i, p in enumerate(prompts):
            srv.submit(Request(uid=i, tokens=p, max_new_tokens=6))
        srv.run()
        done[W] = srv.done
    for i in range(len(prompts)):
        assert done[4][i].generated == done[1][i].generated
        assert done[4][i].token_exit_layers == done[1][i].token_exit_layers
        np.testing.assert_array_equal(done[4][i].result, done[1][i].result)


def test_decoder_server_matches_cpu(cuda):
    """A smoke-size decoder drain on the card against the same on the CPU,
    at full depth (threshold below every entropy) and with every token
    exiting at layer 1 (threshold above every entropy; then also at spec
    window 4): tokens and exits equal, final logits atol 1e-4, and the
    decode kernels launched n_layers x W times per fused step."""
    cfg = dataclasses.replace(get_smoke_config("deepseek_7b"), dtype="float32")
    model = build_model(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = [np.random.default_rng(i).integers(4, cfg.vocab_size, 6 + i) for i in range(5)]
    for thr, W in ((-1.0, 1), (1e9, 1), (1e9, 4)):
        out = {}
        for dev in ("cpu", cuda):
            srv = DecoderServer(model, params, batch_lanes=2, max_seq=32, eos_id=-1, buckets=(16,),
                                exit_threshold=thr, spec_window=W, device=dev)
            for i, p in enumerate(prompts):
                srv.submit(Request(uid=i, tokens=p, max_new_tokens=4))
            ops.reset_launch_counts()
            st = srv.run()
            out[str(dev)] = (srv, ops.launch_counts(), st)
        (cpu, _, _), (gpu, launches, st) = out["cpu"], out[str(cuda)]
        assert launches["softmax_entropy"] == cfg.n_layers * W * st["decode_steps"]
        for i in range(5):
            assert gpu.done[i].generated == cpu.done[i].generated
            assert gpu.done[i].token_exit_layers == cpu.done[i].token_exit_layers
            np.testing.assert_allclose(gpu.done[i].result, cpu.done[i].result, atol=1e-4)


def test_wrappers_raise_instead_of_falling_back(cuda):
    x = _t((4, 8), 21).to(cuda)
    with pytest.raises(TypeError):
        layernorm(x.double(), torch.ones(8, device=cuda, dtype=torch.float64),
                  torch.zeros(8, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        layernorm(x, torch.ones(8), torch.zeros(8))       # gamma on the CPU
    # span attention needs every row 16-byte aligned and the dh axis contiguous
    q = torch.zeros(2 * 64 * 16 + 1, device=cuda)[1:].view(2, 64, 16)
    spans = torch.full((2,), 8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        span_attention(q, q, q, spans, 8, causal=False)
    qt = torch.zeros(2, 16, 64, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError):
        span_attention(qt, qt, qt, spans, 8, causal=False)
    with pytest.raises(TypeError):
        span_attention(qt.contiguous(), qt.contiguous(), qt.contiguous(), spans.long(), 8, causal=False)
    # an index built from the mask alone has no packed tiles: no re-pack
    mask = np.ones((2, 2), bool)
    with pytest.raises(ValueError):
        block_sparse.block_sparse_matmul(_t((4, 64), 22).to(cuda), _t((64, 64), 23).to(cuda),
                                         block_sparse.BlockIndex.build(mask, 32, 32, cuda))
    # the kernel reads the packed tiles, not w: another weight, or the same
    # one modified after packing, raises instead of using stale tiles
    w = _t((64, 64), 23).to(cuda)
    index = block_sparse.BlockIndex.build(mask, 32, 32, cuda, w=w)
    x = _t((4, 64), 22).to(cuda)
    with pytest.raises(ValueError):
        block_sparse.block_sparse_matmul(x, w.clone(), index)
    w.mul_(2.0)
    with pytest.raises(ValueError):
        block_sparse.block_sparse_matmul(x, w, index)


def test_matmul_kernels_deterministic(cuda):
    """Two launches on the same inputs give the same bits: the split-K
    routes reduce their clusters' partials in rank order, without atomics."""
    codes, e_min = af_encode(_t((3072, 768), 24, 1.0 / np.sqrt(3072)))
    codes = codes.to(cuda)
    for m in (128, 512, 2048):
        x = _t((m, 3072), 25).to(cuda)
        assert torch.equal(af_matmul(x, codes, int(e_min)), af_matmul(x, codes, int(e_min)))
    w = _t((3072, 768), 26, 1.0 / np.sqrt(3072))
    w = (w * magnitude_mask(w, 0.5, block_size=32)).to(cuda)
    index = dispatch.mlp_block_masks({"w_down": w})["w_down"]
    for m in (256, 512, 1024):
        x = _t((m, 3072), 27).to(cuda)
        assert torch.equal(block_sparse.block_sparse_matmul(x, w, index),
                           block_sparse.block_sparse_matmul(x, w, index))


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
    assert all(ops.launch_counts()[k] > 0 for k in ops.DEPLOY_KERNELS)
    lc, ec = cpu.classify(tokens)
    np.testing.assert_array_equal(eg, ec)
    np.testing.assert_allclose(lg, lc, atol=1e-4)


def _binade_edges(n_per_side=64, k_range=(-20, 20)):
    out = []
    for k in range(k_range[0], k_range[1] + 1):
        c = np.float32(2.0 ** k).view(np.int32)
        out.append(np.arange(c - n_per_side, c + n_per_side + 1, dtype=np.int32).view(np.float32))
    v = np.concatenate(out)
    return np.concatenate([v, -v])


def test_af_quantize_bit_exact(cuda):
    """atol 0 against the plain version run on the CPU: serving activations
    with one bias per 128-row lane, and every float32 within 64 ulp of 2**k
    for k in [-20, 20], each k its own group."""
    lanes, S, d = 8, 128, 768
    x = _t((lanes * S, d), 31, 2.0)
    x[3 * S:4 * S] *= 1e-3
    x[5 * S + 100:6 * S] *= 50.0
    e_min = group_exp_bias(x, S)
    before = quantize.launches
    got = quantize(x.to(cuda), e_min.to(cuda), S)
    assert quantize.launches == before + 1
    assert torch.equal(got.cpu(), ref.quantize(x, e_min, S))
    edges = [np.concatenate([e, np.zeros((-len(e)) % 32, np.float32)]).reshape(-1, 32)
             for e in (_binade_edges(64, (k, k)) for k in range(-20, 21))]
    v = torch.from_numpy(np.concatenate(edges))
    e_min = group_exp_bias(v, edges[0].shape[0])
    assert torch.equal(quantize(v.to(cuda), e_min.to(cuda), edges[0].shape[0]).cpu(),
                       ref.quantize(v, e_min, edges[0].shape[0]))


@pytest.mark.parametrize("rows,d,rpg", [(1024, 768, 128), (512, 768, 64), (256, 768, 32), (111, 100, 37),
                                        (35, 33, 7), (4096, 768, 4096), (1, 5, 1), (2048, 96, 2)])
def test_af_quantize_groups_bit_exact(cuda, rows, d, rpg):
    """One launch for amax, bias and quantize: e_min equal to
    group_exp_bias and the output bit-exact (atol 0) to the plain version,
    both on the CPU.  The serving shapes (one group per 128 / 64 / 32-row
    lane), groups that are not 16-byte multiples (the scalar route: 37 x 100
    is, 7 x 33 is not), one 4096 x 768 group too large for its cluster's
    registers (read twice), a single element, many small groups; a group
    of lane 3 scaled down and one of lane 5 up, so the biases differ."""
    x = _t((rows, d), 34, 2.0)
    groups = rows // rpg
    if groups > 5:
        x[3 * rpg:4 * rpg] *= 1e-3
        x[5 * rpg:6 * rpg] *= 50.0
    before = quantize.launches
    got, e_min = quantize_groups(x.to(cuda), rpg)
    assert quantize.launches == before + 1
    want_e = group_exp_bias(x, rpg)
    assert torch.equal(e_min.cpu(), want_e)
    assert torch.equal(got.cpu(), ref.quantize(x, want_e, rpg))
    # repeated launches give the same bits
    again, e_again = quantize_groups(x.to(cuda), rpg)
    assert torch.equal(again, got) and torch.equal(e_again, e_min)


def test_af_quantize_groups_binade_edges(cuda):
    """Every float32 within 64 ulp of 2**k, k in [-20, 20], one group per k,
    through the grouped kernel (its bias from each group's amax, its floor
    without the double log away from the binade edges): bit-exact."""
    edges = [np.concatenate([e, np.zeros((-len(e)) % 32, np.float32)]).reshape(-1, 32)
             for e in (_binade_edges(64, (k, k)) for k in range(-20, 21))]
    rpg = edges[0].shape[0]
    v = torch.from_numpy(np.concatenate(edges))
    got, e_min = quantize_groups(v.to(cuda), rpg)
    want_e = group_exp_bias(v, rpg)
    assert torch.equal(e_min.cpu(), want_e)
    assert torch.equal(got.cpu(), ref.quantize(v, want_e, rpg))


def _head_inputs(B, S, D, C, af, seed):
    h = _t((B, S, D), seed)
    pw, cw = _t((D, D), seed + 1, 1 / np.sqrt(D)), _t((D, C), seed + 2, 2 / np.sqrt(D))
    pb, cb = _t((D,), seed + 3, 0.1), _t((C,), seed + 4, 0.1)
    e_min = None
    if af:
        (pw, pe), (cw, ce) = af_encode(pw), af_encode(cw)
        e_min = (int(pe), int(ce))
    active = torch.from_numpy(np.random.default_rng(seed + 5).random(B) < 0.7)
    return h, pw, pb, cw, cb, active, e_min


@pytest.mark.parametrize("af", [False, True])
@pytest.mark.parametrize("B,S,D,C", [(8, 32, 768, 3), (16, 128, 768, 3), (37, 5, 100, 7), (1, 1, 64, 2),
                                     (20, 3, 96, 3), (3, 2, 66, 3)])
def test_offramp_head(cuda, af, B, S, D, C):
    """The head against its plain version on the card (cuBLAS matmuls,
    tanh, softmax entropy, retire): logits and entropies within 1e-5, retire
    equal wherever the entropy lies 1e-4 or more from the threshold (the
    median entropy); the CLS rows read through a strided view of a larger
    h; more than 16 rows (two chunks), widths off the 8-column slices,
    fp32 weights and AF8 codes, rows and slices that are not 16-byte
    multiples (D = 66: the scalar loads); bitwise repeatable."""
    h, pw, pb, cw, cb, active, e_min = (t.to(cuda) if isinstance(t, torch.Tensor) else t
                                        for t in _head_inputs(B, 2 * S, D, C, af, 61))
    hv = h[:, 1::2]                         # every other position: row stride 2 S D, rows at offset D
    want = ref.offramp_head(hv, pw, pb, cw, cb, active, 0.0, e_min)
    thr = float(want[:, C].median())
    want = ref.offramp_head(hv, pw, pb, cw, cb, active, thr, e_min)
    before = softmax_entropy.launches
    got = offramp_head(hv, pw, pb, cw, cb, active=active, threshold=thr, e_min=e_min)
    assert softmax_entropy.launches == before + 1
    torch.testing.assert_close(got[:, :C + 1], want[:, :C + 1], atol=1e-5, rtol=0)
    clear = (want[:, C] - thr).abs() >= 1e-4
    assert torch.equal(got[:, C + 1][clear], want[:, C + 1][clear])
    assert torch.equal(offramp_head(hv, pw, pb, cw, cb, active=active, threshold=thr, e_min=e_min), got)
    # all active without a mask
    got = offramp_head(hv, pw, pb, cw, cb, threshold=thr, e_min=e_min)
    want = ref.offramp_head(hv, pw, pb, cw, cb, None, thr, e_min)
    torch.testing.assert_close(got[:, :C + 1], want[:, :C + 1], atol=1e-5, rtol=0)
    assert torch.equal(got[:, C + 1][clear], want[:, C + 1][clear])


def test_offramp_head_shared_workspace(cuda):
    """The head's counter and partial scratch are kept per (device,
    stream): launches of different B and D queued back to back on one
    stream, then the same launches spread over two streams at once, each
    give the plain version's result."""
    cases = [_head_inputs(B, 3, D, C, af, 80 + i)
             for i, (B, D, C, af) in enumerate([(16, 768, 3, False), (5, 100, 7, True), (8, 768, 3, True),
                                                (37, 96, 2, False)])]
    cases = [tuple(t.to(cuda) if isinstance(t, torch.Tensor) else t for t in c) for c in cases]
    wants = [ref.offramp_head(h, pw, pb, cw, cb, active, 0.0, e) for h, pw, pb, cw, cb, active, e in cases]

    def check(gots):
        for got, want in zip(gots, wants):
            C = want.shape[1] - 2
            torch.testing.assert_close(got[:, :C + 1], want[:, :C + 1], atol=1e-5, rtol=0)

    check([offramp_head(h, pw, pb, cw, cb, active=active, e_min=e) for h, pw, pb, cw, cb, active, e in cases])
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda))
    gots = []
    for _ in range(20):
        for i, (h, pw, pb, cw, cb, active, e) in enumerate(cases):
            with torch.cuda.stream(streams[i % 2]):
                gots.append(offramp_head(h, pw, pb, cw, cb, active=active, e_min=e))
    torch.cuda.synchronize(cuda)
    for k in range(0, len(gots), len(cases)):
        check(gots[k:k + len(cases)])


def test_offramp_head_raises(cuda):
    h, pw, pb, cw, cb, active, _ = _head_inputs(4, 2, 64, 3, False, 71)
    h, pw, pb, cw, cb, active = (t.to(cuda) for t in (h, pw, pb, cw, cb, active))
    with pytest.raises(TypeError):
        offramp_head(h, pw, pb, cw, cb, active=active.int())       # active must be bool
    with pytest.raises(TypeError):
        offramp_head(h, pw, pb, cw, cb, e_min=(0, 0))              # fp32 weights passed as codes
    with pytest.raises(ValueError):
        offramp_head(h.transpose(1, 2), pw, pb, cw, cb)           # D not contiguous
    with pytest.raises(ValueError):
        offramp_head(h, pw[:, :32], pb, cw, cb)                   # pooler not [D, D]


@pytest.mark.parametrize("M,K,N", [(1024, 768, 3072), (1024, 3072, 768), (37, 96, 128),
                                   (256, 3072, 768), (512, 3072, 768)])
def test_block_sparse_matmul(cuda, M, K, N):
    """rtol 1e-5 + atol 1e-5 (float32 sums in another order), on weights
    pruned at 32x32 tiles, one n-block left with no tile (zeros out); the
    kernel reads the index's packed tiles (split-K at M = 256 and 512)."""
    w = _t((K, N), 32, 1.0 / np.sqrt(K))
    w = w * magnitude_mask(w, 0.5, block_size=32)
    w[:, 32:64] = 0.0
    mask = dispatch.mlp_block_masks({"w_up": w})["w_up"]
    assert mask is not None and not mask.mask[:, 1].any()
    x = _t((M, K), 33)
    wc = w.to(cuda)
    index = block_sparse.BlockIndex.build(mask.mask, 32, 32, cuda, w=wc)
    got = block_sparse.block_sparse_matmul(x.to(cuda), wc, index)
    want = ref.block_sparse_matmul(x, w, mask.mask, 32, 32)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    assert (got[:, 32:64] == 0).all()


@pytest.mark.parametrize("S", [32, 128])
def test_span_attention_serving_kv_lens(cuda, S):
    """The serving step's route: window = S, every span S, lengths drawn in
    [1, S]; atol 2e-5."""
    BH, dh = 96, 64
    q, k, v = (_t((BH, S, dh), s) for s in (41, 42, 43))
    spans = torch.full((BH,), S, dtype=torch.int32)
    lens = torch.from_numpy(np.random.default_rng(44).integers(1, S + 1, BH // 12).astype(np.int32))
    lens = lens.repeat_interleave(12)
    want = span_attention(q, k, v, spans, S, causal=False, kv_lens=lens)
    got = span_attention(q.to(cuda), k.to(cuda), v.to(cuda), spans.to(cuda), S, causal=False,
                         kv_lens=lens.to(cuda))
    torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=0)


def test_classifier_server_matches_cpu(cuda):
    """A short smoke-size drain (span off, MLP block-pruned) on the card
    against the same drain on the CPU: exits equal, logits atol 1e-4, and
    every serving kernel launched."""
    cfg = get_smoke_config("albert_edgebert")
    cfg = dataclasses.replace(cfg, dtype="float32").with_edgebert(
        span=dataclasses.replace(cfg.edgebert.span, enabled=False),
        early_exit=dataclasses.replace(cfg.edgebert.early_exit, entropy_threshold=0.0))
    model = build_model(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for name in ("w_up", "w_down"):
        w = params["layer"]["mlp"][name]
        params["layer"]["mlp"][name] = w * magnitude_mask(w, 0.5, block_size=32)
    toks = SyntheticCLS(cfg.vocab_size, 32, 6, num_classes=3, seed=0).batch(0)["tokens"]
    out = {}
    for dev in ("cpu", cuda):
        srv = ClassifierServer(model, params, batch_lanes=4, buckets=(16, 32), device=dev)
        for i, n in enumerate((12, 32, 9, 24, 16, 5)):
            srv.submit(Request(uid=i, tokens=toks[i][:n]))
        ops.reset_launch_counts()
        srv.run()
        out[str(dev)] = (srv, ops.launch_counts())
    cpu, gpu = out["cpu"][0], out[str(cuda)][0]
    assert all(out[str(cuda)][1][k] > 0 for k in ops.SERVING_KERNELS)
    assert all(n == 0 for n in out["cpu"][1].values())
    for i in range(6):
        assert gpu.done[i].exit_layer == cpu.done[i].exit_layer == cfg.n_layers
        np.testing.assert_allclose(gpu.done[i].result, cpu.done[i].result, atol=1e-4)


def test_block_index_refuses_inference_mode_weight_on_card(cuda):
    """An inference-mode weight keeps no version counter, so its packed
    tiles could go stale unnoticed: the card route refuses it at build and
    at the launch's weight check."""
    w = _t((64, 64), 50)
    mask = np.ones((2, 2), bool)
    mask[1, 0] = False
    wc = w.to(cuda)
    index = block_sparse.BlockIndex.build(mask, 32, 32, cuda, w=wc)
    x = _t((8, 64), 51).to(cuda)
    block_sparse.block_sparse_matmul(x, wc, index)
    with torch.inference_mode():
        w_inf = w.to(cuda) + 0.0
    with pytest.raises(ValueError, match="inference-mode"):
        block_sparse.BlockIndex.build(mask, 32, 32, cuda, w=w_inf)
    with pytest.raises(ValueError, match="inference-mode"):
        block_sparse.block_sparse_matmul(x, w_inf, index)


def test_smoke_replay_matches_cpu(cuda):
    """A 64-event smoke-size mmpp_multitask replay (span off, MLP
    block-pruned, four tasks with their own weights) on the card against
    the same replay on the CPU: summaries_identical, every request served
    by the same task with the same exit layer, and every kernel of the
    replay path launched on the card (none on the CPU)."""
    from repro_torch.launch import replay
    from repro_torch.serving.workload import TraceReplayer, generate_trace, summaries_identical

    tasks = [t for t, _ in replay.MMPP_MULTITASK["tasks"]]
    cfg = replay.replay_config(smoke=True)
    cfg = cfg.with_edgebert(span=dataclasses.replace(cfg.edgebert.span, enabled=False))
    st = replay.build_stack(cfg, tasks, prune=True)
    out = {}
    for dev in ("cpu", cuda):
        target = replay.build_target(st.cfg, st.embed, st.by_task, st.ctrl_factory, device=dev,
                                     target_cls=replay.RecordingRouterTarget)
        ops.reset_launch_counts()
        summary = TraceReplayer(target, vocab_size=st.cfg.vocab_size, token_seed=0).replay(
            generate_trace(st.wl, 64, service_s=st.svc))
        out[str(dev)] = (summary, target.record, ops.launch_counts())
    (s_cpu, rec_cpu, n_cpu), (s_gpu, rec_gpu, n_gpu) = out["cpu"], out[str(cuda)]
    assert summaries_identical(s_gpu, s_cpu)
    assert rec_gpu == rec_cpu and len(rec_gpu) == s_gpu["completed"] > 0
    assert all(n_gpu[k] > 0 for k in ops.REPLAY_KERNELS), n_gpu
    assert all(n == 0 for n in n_cpu.values())


# ---------------------------------------------------------------------------
# Training on the card
# ---------------------------------------------------------------------------


def _train_setup(quant=False):
    from repro_torch.configs.base import PruneConfig, SpanConfig

    cfg = dataclasses.replace(get_smoke_config("albert_edgebert"), dtype="float32", remat_policy="none")
    cfg = cfg.with_edgebert(
        prune=PruneConfig(enabled=True, method="magnitude", encoder_sparsity=0.5, end_step=2, update_every=1,
                          block_size=16),
        span=SpanConfig(enabled=True, max_span=128, ramp=16, loss_coef=0.05, init_span=16.0),
        quant=dataclasses.replace(cfg.edgebert.quant, enabled=quant), distill_alpha=0.5)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


def _flat(tree):
    from repro_torch.common.util import tree_leaves_with_path

    return dict(tree_leaves_with_path(tree))


def test_training_step_matches_cpu(cuda):
    """Three smoke-size phase-1 steps (magnitude pruning in 16x16 tiles,
    spans at an integer init, distillation) on the card and on the CPU from
    the same weights (activation quantization off, whose AF boundaries would
    turn an ulp into a quantum): losses within 1e-5 relative; the first
    step's gradients within 1e-5 of their leaf's largest and its params
    within 1e-5 (float32 sums in another order); after three steps every
    param within 1e-4, both but where Adam's step is ill-conditioned in the
    gradient (its ties): where the two gradients took opposite signs (the
    first step is sign(g) * lr), or where they differ and one is within 100
    eps of 0 (the step g / (|g| + eps) then turns the gradient's last
    digits into a visible fraction of lr); masks equal (no tile norm within 1e-6 of the
    threshold here); and no kernel launched: training takes the reference
    ops."""
    from repro_torch.common.device import tree_to
    from repro_torch.training.optim import AdamWConfig
    from repro_torch.training.train_loop import EdgeBertTrainer, TrainerConfig

    cfg, params = _train_setup()
    teacher = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    data = SyntheticCLS(cfg.vocab_size, 32, 8, num_classes=3, seed=0)
    runs, grads, first = {}, {}, {}
    for dev in ("cpu", cuda):
        tr = EdgeBertTrainer(build_model(cfg), TrainerConfig(
            phase1_steps=3, phase2_steps=0, opt=AdamWConfig(lr=2e-3, warmup_steps=2, total_steps=10,
                                                            span_lr_mult=300.0)),
            teacher_params=tree_to(teacher, torch.device(dev)))
        seen = grads[str(dev)] = []

        def recording(*a, _fn=tr.phase1_step, _seen=seen):
            out = _fn(*a)
            _seen.append({k: v.cpu() for k, v in _flat(out[2]).items()})
            return out

        tr.phase1_step = recording
        ops.reset_launch_counts()
        runs[str(dev)] = tr.phase1(tree_to(params, torch.device(dev)), data, log_every=1000, callbacks=[
            lambda step, p, m, _d=str(dev): first.setdefault(_d, {k: v.cpu() for k, v in _flat(p).items()})])
        assert sum(ops.launch_counts().values()) == 0
    (cp, cs, ch), (gp, gs, gh) = runs["cpu"], runs[str(cuda)]
    for c, g in zip(ch, gh):
        assert abs(c["loss"] - g["loss"]) <= 1e-5 * abs(c["loss"])
    for path, want in grads["cpu"][0].items():      # the first step's, from the same params
        got = grads[str(cuda)][0][path]
        torch.testing.assert_close(got, want, atol=1e-5 * float(want.abs().max()), rtol=0, msg=path)
    for after, cpu_p, card_p, atol in ((1, first["cpu"], first[str(cuda)], 1e-5), (3, _flat(cp), _flat(gp), 1e-4)):
        for path, leaf in cpu_p.items():
            tie = torch.zeros_like(leaf, dtype=torch.bool)      # Adam's ties
            for g_cpu, g_card in list(zip(grads["cpu"], grads[str(cuda)]))[:after]:
                tie |= torch.sign(g_cpu[path]) != torch.sign(g_card[path])
                tie |= (torch.minimum(g_cpu[path].abs(), g_card[path].abs()) < 100 * tr.tcfg.opt.eps) & (
                    g_cpu[path] != g_card[path])
            diff = (card_p[path].cpu() - leaf).abs()
            assert not ((diff > atol) & ~tie).any(), (after, path, float(diff.max()))
    for path, m in _flat(cs.masks).items():
        assert torch.equal(_flat(gs.masks)[path].cpu(), m), path


def test_wrappers_refuse_grad_inputs_on_card(cuda):
    """A CUDA input that requires grad, with grad enabled, is refused by every
    wrapper (no kernel has a backward); under no_grad the same call runs."""
    from repro_torch.kernels.adaptivfloat_k import quantize_groups as qg

    x = _t((32, 64), 31).to(cuda).requires_grad_()
    g, b = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    codes, e_min = af_encode(_t((64, 64), 32))
    calls = {
        "layernorm": lambda: layernorm(x, g, b),
        "softmax_entropy": lambda: softmax_entropy(x),
        "entropy": lambda: entropy(x),
        "quantize_groups": lambda: qg(x, 4),
        "af_matmul": lambda: af_matmul(x, codes.to(cuda), int(e_min)),
        "span_attention": lambda: span_attention(x.view(2, 16, 64), x.view(2, 16, 64), x.view(2, 16, 64),
                                                 torch.full((2,), 8, dtype=torch.int32, device=cuda), 8,
                                                 causal=False),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            call()
    w = _t((64, 64), 33).to(cuda)
    index = block_sparse.BlockIndex.build(np.ones((2, 2), bool), 32, 32, cuda, w=w)
    with pytest.raises(RuntimeError, match="no backward"):
        block_sparse.block_sparse_matmul(x, w, index)


def test_checkpoint_from_card_restores_on_cpu(cuda, tmp_path):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.common.device import tree_to
    from repro_torch.training.optim import adamw_init

    _, params = _train_setup()
    card = tree_to(params, cuda)
    mgr = CheckpointManager(str(tmp_path), save_every=1)
    mgr.maybe_save(1, {"params": card, "opt": adamw_init(card)})
    restored, manifest = mgr.restore_latest({"params": params, "opt": adamw_init(params)})
    assert manifest["step"] == 1
    for path, leaf in _flat(restored).items():
        want = _flat({"params": card, "opt": adamw_init(card)})[path]
        assert leaf.device.type == "cpu" and torch.equal(leaf, want.cpu()), path
    on_card, _ = mgr.restore_latest({"params": params}, device=cuda)
    assert all(t.is_cuda for t in _flat(on_card).values())

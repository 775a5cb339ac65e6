"""The arithmetic and the operand routes of the tensor-core span kernels, on
the CPU.

csrc/span_attention.cu computes attention on bf16 tensor cores: q (scaled
in float32), k, v and the probabilities P are split exactly into three bf16
terms, each k16 step sums the six products with i + j <= 2, the softmax is
online over 32-key tiles, P's score fragments are reused as the A fragments
of P V, and V's B fragments come by ldmatrix.trans.  These tests hold a
float64 emulation of that arithmetic (with the kernel's tile visits)
against the JAX package's Pallas kernel in interpret mode, check the
kernel's fragment maps against maps written from the PTX description, and
check that the strided operand routes of ``span_attention_heads``,
``dispatch.dense_attention`` and ``ops.span_attention_op`` compute the same
as contiguous copies through ``span_attention`` and as the JAX functions,
without copying q, k, v or the output.

csrc/span_attention_long.cu, the long full-window rows' kernel, runs the
same products on wgmma over 64-key tiles of planes split once by a
pre-pass: its emulation (every row visits the tiles below its kv_len) is
held against the Pallas kernel too, its register and shared-memory maps
against the PTX description of wgmma, and the rule that picks it against
the calls each caller makes.
"""
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import jax.numpy as jnp
from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro.kernels.span_attention import span_attention as j_span_attention
from repro_torch.kernels import block_sparse, dispatch, ops
from repro_torch.kernels import span_attention as span_k

BQ, BKV, WARP_ROWS = 64, 32, 16     # the kernel's query tile, key tile, rows per warp
NEG_INF = -1e30


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _split(x: np.ndarray):
    """The exact three-way bf16 split (split_mma.cuh split3), as float64."""
    return [t.double().numpy() for t in block_sparse.split_bf16(_t(np.asarray(x, np.float32)))]


def _six(a, b):
    """sum over i + j <= 2 of a_i @ b_j, exact in float64."""
    return sum(a[i] @ b[j] for i in range(3) for j in range(3) if i + j <= 2)


def emulate(q, k, v, spans, window, causal, kv_lens=None):
    """float64 emulation of csrc/span_attention.cu over [BH, S, dh] rows:
    the block's and each warp's tile visits, the six split products of Q K^T
    per key tile, the online softmax with P rounded to float32 and split
    three ways against V's planes, zeros where l == 0."""
    BH, Sq, dh = q.shape
    Sk = k.shape[1]
    scale = np.float32(1.0 / np.sqrt(dh))
    Q = _split(q * scale)                                  # float32 product, then split
    pad = (-Sk) % BKV + BKV
    out = np.zeros((BH, Sq, dh))
    for bh in range(BH):
        span = min(int(spans[bh]), window)
        kvl = Sk if kv_lens is None else min(int(kv_lens[bh]), Sk)
        # keys past kv_len arrive as zeros (cp.async zero fill)
        kz = np.pad(np.where(np.arange(Sk)[:, None] < kvl, k[bh], 0), ((0, pad), (0, 0)))
        vz = np.pad(np.where(np.arange(Sk)[:, None] < kvl, v[bh], 0), ((0, pad), (0, 0)))
        K, V = _split(kz), _split(vz)
        for q0 in range(0, Sq, BQ):
            kt_lo, kt_hi = 0, -1
            if span > 0 and kvl > 0:
                q_last = min(q0 + BQ, Sq) - 1
                kt_lo = max(q0 - (span - 1), 0) // BKV
                kt_hi = min(q_last if causal else q_last + span - 1, kvl - 1) // BKV
            for w in range(BQ // WARP_ROWS):
                first = q0 + WARP_ROWS * w
                if first >= Sq:
                    continue
                last = min(first + WARP_ROWS - 1, Sq - 1)
                wk_lo = first - (span - 1)
                wk_hi = min(last if causal else last + span - 1, kvl - 1)
                rows = np.arange(first, first + WARP_ROWS)
                rq = np.minimum(rows, Sq - 1)
                Qw = [np.where((rows < Sq)[:, None], x[bh, rq], 0.0) for x in Q]
                m = np.full(WARP_ROWS, NEG_INF)
                l = np.zeros(WARP_ROWS)
                o = np.zeros((WARP_ROWS, dh))
                for kt in range(kt_lo, kt_hi + 1):
                    k0 = kt * BKV
                    if k0 > wk_hi or k0 + BKV - 1 < wk_lo:
                        continue
                    keys = np.arange(k0, k0 + BKV)
                    s = _six(Qw, [x[keys].T for x in K])
                    d = rows[:, None] - keys[None, :]
                    vis = ((d >= 0) & (d < span)) if causal else (np.abs(d) < span)
                    vis &= (keys[None, :] < kvl) & (rows[:, None] < Sq)
                    s = np.where(vis, s, NEG_INF)
                    m_new = np.maximum(m, s.max(axis=1))
                    corr = np.exp(m - m_new)
                    p = np.where(vis, np.exp(s - m_new[:, None]), 0.0).astype(np.float32)
                    l = l * corr + p.sum(axis=1, dtype=np.float64)
                    o = o * corr[:, None] + _six(_split(p), [x[keys] for x in V])
                    m = m_new
                ok = rows < Sq
                res = np.where((l > 0)[:, None], o / np.maximum(l, 1e-20)[:, None], 0.0)
                out[bh, rows[ok]] = res[ok]
    return out


CASES = [
    # BH, S, dh, window, causal, kv_lens seed or None
    (4, 100, 16, 37, True, None),
    (4, 100, 16, 37, False, None),
    (3, 200, 32, 200, False, 1),
    (3, 200, 32, 200, True, 1),
    (4, 64, 64, 64, False, 2),
    (2, 128, 128, 50, False, None),
]


@pytest.mark.parametrize("BH,S,dh,window,causal,kv", CASES)
def test_split_emulation_matches_pallas(BH, S, dh, window, causal, kv):
    """Within atol 2e-5 of the Pallas kernel (the tolerance the port's
    span_attention is held to); ragged S, span 0 (a row of zeros) and
    kv_lens below a tile, on a tile edge and at S."""
    q, k, v = _np((BH, S, dh), 11), _np((BH, S, dh), 12), _np((BH, S, dh), 13)
    spans = np.random.default_rng(14).integers(1, window + 1, BH).astype(np.int32)
    spans[0] = 0
    lens = None
    if kv is not None:
        lens = np.random.default_rng(kv).integers(1, S + 1, BH).astype(np.int32)
        lens[: 3] = [5, 32, S][:BH]
    want = np.asarray(j_span_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(spans), window, causal=causal,
        bq=32, bk=32, kv_lens=None if lens is None else jnp.asarray(lens)))
    got = emulate(q, k, v, spans, window, causal, lens)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    assert (got[0] == 0).all()


LONG_BN = 64         # the long kernel's key tile


def emulate_long(q, k, v, kv_lens=None):
    """float64 emulation of csrc/span_attention_long.cu over [BH, S, 64]
    rows with every key below kv_len visible: the pre-pass's planes (keys
    past kv_len zero), each row's visits to the 64-key tiles below its
    kv_len, per tile the four k16 chains of six split products promoted in
    order into the scores, the online softmax with P rounded to float32 and
    split three ways, the four k16 chains of P V promoted in order into the
    output, zeros where l == 0."""
    BH, Sq, dh = q.shape
    Sk = k.shape[1]
    Q = _split(q * np.float32(1.0 / np.sqrt(dh)))
    out = np.zeros((BH, Sq, dh))
    for bh in range(BH):
        kvl = Sk if kv_lens is None else min(int(kv_lens[bh]), Sk)
        n = -(-max(kvl, 0) // LONG_BN)
        live = (np.arange(n * LONG_BN) < kvl)[:, None]
        kz = np.where(live, np.pad(k[bh], ((0, max(n * LONG_BN - Sk, 0)), (0, 0)))[: n * LONG_BN], 0)
        vz = np.where(live, np.pad(v[bh], ((0, max(n * LONG_BN - Sk, 0)), (0, 0)))[: n * LONG_BN], 0)
        K, V = _split(kz), _split(vz)
        Qr = [x[bh] for x in Q]
        m = np.full(Sq, NEG_INF)
        l = np.zeros(Sq)
        o = np.zeros((Sq, dh))
        for t in range(n):
            keys = np.arange(t * LONG_BN, (t + 1) * LONG_BN)
            s = 0.0
            for ks in range(dh // 16):
                d = slice(16 * ks, 16 * ks + 16)
                s = s + _six([x[:, d] for x in Qr], [x[keys, d].T for x in K])
            vis = (keys < kvl)[None, :]
            s = np.where(vis, s, NEG_INF)
            m_new = np.maximum(m, s.max(axis=1))
            corr = np.exp(m - m_new)
            p = np.where(vis, np.exp(s - m_new[:, None]), 0.0).astype(np.float32)
            l = l * corr + p.sum(axis=1, dtype=np.float64)
            P = _split(p)
            pv = 0.0
            for kk in range(LONG_BN // 16):
                c = slice(16 * kk, 16 * kk + 16)
                pv = pv + _six([x[:, c] for x in P], [x[keys[c]] for x in V])
            o = o * corr[:, None] + pv
            m = m_new
        out[bh] = np.where((l > 0)[:, None], o / np.maximum(l, 1e-20)[:, None], 0.0)
    return out


@pytest.mark.parametrize("BH,S,kv", [(3, 130, (5, 64, 130)), (2, 200, None), (4, 64, (0, 1, 63, 64))])
def test_long_emulation_matches_pallas(BH, S, kv):
    """The long kernel's arithmetic within atol 2e-5 of the Pallas kernel
    at a full window: kv_len of 0 (a row of zeros), 1, below, on and past a
    64-key tile edge, ragged S."""
    q, k, v = _np((BH, S, 64), 21), _np((BH, S, 64), 22), _np((BH, S, 64), 23)
    lens = None if kv is None else np.asarray(kv, np.int32)
    want = np.asarray(j_span_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.full((BH,), S, jnp.int32), S, causal=False,
        bq=32, bk=32, kv_lens=None if lens is None else jnp.asarray(lens)))
    got = emulate_long(q, k, v, lens)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    if lens is not None and lens[0] == 0:
        assert (got[0] == 0).all()


def _called(monkeypatch, call):
    """The (dh, causal, per-head spans, window, Sq, Sk) of every span kernel
    call ``call`` makes, with the kernel stubbed out (no attention is
    computed), and what ``long_rows`` decides for each."""
    seen = []

    def kernel(q_, k_, v_, spans, window, *, causal, kv_lens=None, out=None):
        B, H, Sq, dh = q_.shape
        args = (dh, causal, spans is not None, int(window), Sq, k_.shape[2])
        seen.append((args, span_k.long_rows(*args)))
        return torch.zeros(q_.shape) if out is None else out

    monkeypatch.setattr(span_k, "span_attention_heads", kernel)
    call()
    assert seen
    return seen


def _zeros(B, S, H, dh):
    return torch.zeros(B, S, H, dh)


LONG_CASES = [
    # caller, (B, Sq, Sk, H, dh), window or route, causal, long path
    ("albert", (4, 32, 32, 12, 64), None, False, False),
    ("albert", (4, 64, 64, 12, 64), None, False, False),
    ("albert", (4, 128, 128, 12, 64), None, False, False),
    ("modernbert_local", (1, 8192, 8192, 16, 64), 65, False, False),
    ("modernbert_local", (1, 2048, 2048, 16, 64), 65, False, False),
    ("deployed_spans", (4, 128, 128, 12, 64), "spans", False, False),
    ("decoder_causal", (2, 512, 512, 4, 128), None, True, False),
    ("decoder_causal", (2, 512, 512, 8, 64), None, True, False),
    ("whisper_cross", (2, 1, 1500, 16, 64), None, False, False),
    ("whisper_cross", (2, 4, 1500, 16, 64), None, False, False),
    ("modernbert_global", (1, 2048, 2048, 16, 64), None, False, True),
    ("modernbert_global", (2, 4096, 4096, 16, 64), None, False, True),
    ("modernbert_global", (1, 8192, 8192, 16, 64), None, False, True),
    ("whisper_encoder", (1, 1500, 1500, 16, 64), None, False, True),
]


@pytest.mark.parametrize("caller,shape,window,causal,long", LONG_CASES,
                         ids=[f"{c[0]}-{c[1][1]}x{c[1][2]}-dh{c[1][4]}" for c in LONG_CASES])
def test_long_rows_at_every_caller_shape(monkeypatch, caller, shape, window, causal, long):
    """Which kernel each caller's calls take: ALBERT's rows (32 / 64 / 128),
    ModernBERT's local layers (window 65), the deployed spans, causal rows
    and whisper-sized cross-attention keep the short-row kernel; ModernBERT's
    global layers at 2048 / 4096 / 8192 and a 1500-frame full window take
    the long one.  The calls are made through ``dispatch.dense_attention``
    and ``ops.span_attention_op``, as the models make them."""
    B, Sq, Sk, H, dh = shape
    q, k, v = _zeros(B, Sq, H, dh), _zeros(B, Sk, H, dh), _zeros(B, Sk, H, dh)
    kv = torch.full((B,), Sk, dtype=torch.int32)
    if window == "spans":
        call = lambda: ops.span_attention_op(q, k, v, [64, 0, 128] + [32] * (H - 3), causal=causal)
    else:
        call = lambda: dispatch.dense_attention(q, k, v, causal=causal, kv_len=kv, window=window)
    seen = _called(monkeypatch, call)
    assert [d for _, d in seen] == [long] * len(seen), seen


def test_long_rows_rule():
    """Each condition of the rule alone sends a global-layer call back to
    the short-row kernel."""
    base = dict(dh=64, causal=False, per_head_spans=False, window=8192, Sq=8192, Sk=8192)
    assert span_k.long_rows(**base)
    for change in (dict(dh=128), dict(dh=32), dict(causal=True), dict(per_head_spans=True), dict(window=8191),
                   dict(Sq=1023, window=8192), dict(Sk=1023, Sq=1023, window=1023), dict(Sq=1, Sk=8192),
                   dict(Sq=16384)):
        assert not span_k.long_rows(**{**base, **change}), change
    assert span_k.long_rows(**{**base, "Sq": 1024, "Sk": 1024, "window": 1024})


# ---------------------------------------------------------------------------
# Fragment maps: the kernel's index expressions against the PTX description
# of mma.sync m16n8k16 (bf16) and ldmatrix.x4.trans
# ---------------------------------------------------------------------------


def _a_fragment(lane):
    """PTX: (row, k) of A registers a0..a3, two halves each (low first)."""
    g, t = lane // 4, lane % 4
    return [[(g, 2 * t), (g, 2 * t + 1)], [(g + 8, 2 * t), (g + 8, 2 * t + 1)],
            [(g, 2 * t + 8), (g, 2 * t + 9)], [(g + 8, 2 * t + 8), (g + 8, 2 * t + 9)]]


def _b_fragment(lane):
    """PTX: (k, n) of B registers b0, b1, two halves each (low first)."""
    g, t = lane // 4, lane % 4
    return [[(2 * t, g), (2 * t + 1, g)], [(2 * t + 8, g), (2 * t + 9, g)]]


def _c_fragment(lane):
    """PTX: (row, col) of C registers c0..c3."""
    g, t = lane // 4, lane % 4
    return [(g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t), (g + 8, 2 * t + 1)]


def test_score_fragments_are_the_a_fragments_of_p_v():
    """The kernel packs pa[r] from s[2kk + (r >> 1)][2(r & 1)], s[..][2(r & 1) + 1]
    (C fragments of n8 key tiles 2kk and 2kk+1); read back through the PTX
    A layout that is P[row, 16kk + k] for every lane and register."""
    P = np.arange(16 * BKV, dtype=np.float64).reshape(16, BKV)
    for lane in range(32):
        # s[j][r]: the lane's C fragment of n8 key tile j
        s = [[P[r_, 8 * j + c_] for r_, c_ in _c_fragment(lane)] for j in range(BKV // 8)]
        for kk in range(BKV // 16):
            pa = [(s[2 * kk + (r >> 1)][2 * (r & 1)], s[2 * kk + (r >> 1)][2 * (r & 1) + 1])
                  for r in range(4)]
            for reg, halves in enumerate(_a_fragment(lane)):
                for half, (row, kcol) in enumerate(halves):
                    assert pa[reg][half] == P[row, 16 * kk + kcol]


def _ldmatrix_x4_trans(smem, addrs):
    """PTX ldmatrix.m8n8.x4.trans.b16: lanes 8i..8i+7 give the addresses of
    rows 0..7 of matrix i (8 consecutive elements each); register i of lane
    (g, t) receives matrix i transposed: (row 2t, col g) low, (2t+1, g) high."""
    regs = []
    for lane in range(32):
        g, t = lane // 4, lane % 4
        regs.append([(smem[addrs[8 * i + 2 * t] + g], smem[addrs[8 * i + 2 * t + 1] + g])
                     for i in range(4)])
    return regs


@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_plane_fragments_match_the_mma_layout(dh):
    """K's B fragments (32-bit loads at (8j + g) * LD + 2t + 16ks (+8)) are
    K^T's, V's (ldmatrix.x4.trans, lane 8mi + ri at row 16kk + 8(mi & 1) + ri,
    column 8n + 8(mi >> 1)) are V's, for every lane, tile and step; and the
    8-element padding leaves both reads free of bank conflicts."""
    LD = dh + 8
    plane = np.arange(BKV * LD).reshape(BKV, LD)      # element id = its offset
    flat = plane.reshape(-1)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for j in range(BKV // 8):
            for ks in range(dh // 16):
                base = (8 * j + g) * LD + 2 * t + 16 * ks
                words = [(flat[base], flat[base + 1]), (flat[base + 8], flat[base + 9])]
                for reg, halves in enumerate(_b_fragment(lane)):
                    for half, (kd, n) in enumerate(halves):
                        assert words[reg][half] == plane[8 * j + n, 16 * ks + kd]   # B = K^T
    for kk in range(BKV // 16):
        for n in range(0, dh // 8, 2):
            addrs = [(16 * kk + 8 * ((ln >> 3) & 1) + (ln & 7)) * LD + 8 * n + 8 * (ln >> 4)
                     for ln in range(32)]
            regs = _ldmatrix_x4_trans(flat, addrs)
            for lane in range(32):
                for nn in range(2):
                    for reg, halves in enumerate(_b_fragment(lane)):
                        for half, (kd, col) in enumerate(halves):
                            assert regs[lane][2 * nn + reg][half] == plane[16 * kk + kd, 8 * (n + nn) + col]
            # one phase per matrix: its 8 rows of 16 bytes on distinct banks
            for i in range(4):
                banks = {(addrs[8 * i + r] * 2 // 4 + w) % 32 for r in range(8) for w in range(4)}
                assert len(banks) == 32
    # the K loads: 32 lanes' 32-bit words on 32 distinct banks
    for j in range(BKV // 8):
        banks = {(((8 * j + ln // 4) * LD + 2 * (ln % 4)) * 2 // 4) % 32 for ln in range(32)}
        assert len(banks) == 32


# ---------------------------------------------------------------------------
# The long kernel's maps against the PTX description of wgmma m64nNk16
# (bf16, f32 accumulate) and of its canonical K-major shared-memory layout
# ---------------------------------------------------------------------------

LONG_SRC = (Path(span_k.__file__).resolve().parents[1] / "csrc" / "span_attention_long.cu").read_text()


def _wgmma_d(warp, lane, n):
    """PTX: (row, col) of accumulator registers d[0 .. n / 2) of thread
    (warp, lane) of the warpgroup, m64nNk16 f32."""
    g, t = lane // 4, lane % 4
    return [(16 * warp + g + 8 * ((i >> 1) & 1), 8 * (i >> 2) + 2 * t + (i & 1)) for i in range(n // 2)]


def _wgmma_a(warp, lane):
    """PTX: (row, k) of the register A fragment a0..a3 of m64nNk16 bf16, two
    halves each (low first)."""
    g, t = lane // 4, lane % 4
    r = 16 * warp + g
    return [[(r, 2 * t), (r, 2 * t + 1)], [(r + 8, 2 * t), (r + 8, 2 * t + 1)],
            [(r, 2 * t + 8), (r, 2 * t + 9)], [(r + 8, 2 * t + 8), (r + 8, 2 * t + 9)]]


def test_long_scores_are_the_a_fragments_of_p_v():
    """split_p packs register r of k16 step kk from d[8 kk + 2 r] and
    d[8 kk + 2 r + 1] of the m64n64 score accumulator; read through the
    PTX register A layout that is P[row, 16 kk + k] for every thread."""
    assert "split3(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], p[0][r], p[1][r], p[2][r]);" in LONG_SRC
    P = np.arange(64 * LONG_BN, dtype=np.float64).reshape(64, LONG_BN)
    for warp in range(4):
        for lane in range(32):
            d = [P[r, c] for r, c in _wgmma_d(warp, lane, LONG_BN)]
            for kk in range(LONG_BN // 16):
                pa = [(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]) for r in range(4)]
                for reg, halves in enumerate(_wgmma_a(warp, lane)):
                    for half, (row, kcol) in enumerate(halves):
                        assert pa[reg][half] == P[row, 16 * kk + kcol]


def _core(row, col):
    """csrc/span_attention_long.cu ``core``: element offset in a plane."""
    return (row >> 3) * 512 + (col >> 3) * 64 + (row & 7) * 8 + (col & 7)


def test_long_planes_are_the_canonical_k_major_layout():
    """The pre-pass writes element (row, col) of a 64 x 64 plane at
    ``core(row, col)``; the descriptors (no swizzle, LBO 128 bytes, SBO 1024
    bytes, k16 step ks at 256 ks bytes) read element (row, k) of step ks at
    start + 16 (row % 8) + SBO (row // 8) + 2 (k % 8) + LBO (k // 8), the PTX
    canonical K-major layout ((8, m), (T, 2)) : ((1T, SBO), (1, LBO)); the
    two agree for every element, and the epilogue and masks read columns
    of the accumulator as the PTX D layout places them."""
    assert "return (row >> 3) * 512 + (col >> 3) * 64 + (row & 7) * 8 + (col & 7);" in LONG_SRC
    # the wrapper's scratch: six 64 x 64 bf16 planes per 64-key tile
    for line in ("constexpr int BN = 64;", "constexpr int DH = 64;", "constexpr int PLANE_BYTES = BN * DH * 2;",
                 "constexpr int TILE_BYTES = 6 * PLANE_BYTES;"):
        assert line in LONG_SRC, line
    assert (span_k.LONG_KEY_TILE, span_k.LONG_TILE_BYTES) == (LONG_BN, 6 * 64 * 64 * 2)
    assert "(static_cast<uint64_t>(128 >> 4) << 16)" in LONG_SRC
    assert "(static_cast<uint64_t>(1024 >> 4) << 32)" in LONG_SRC
    assert "const uint32_t o = 256 * ks;" in LONG_SRC and "const uint32_t o = 256 * kk;" in LONG_SRC
    LBO, SBO = 128, 1024
    seen = set()
    for ks in range(4):
        for row in range(64):
            for k in range(16):
                addr = 256 * ks + 16 * (row % 8) + SBO * (row // 8) + 2 * (k % 8) + LBO * (k // 8)
                assert addr == 2 * _core(row, 16 * ks + k)
                seen.add(addr)
    assert seen == set(range(0, 2 * 64 * 64, 2))          # a bijection onto the 8 KB plane
    # the masks' and the epilogue's columns: d[i] is column 8 (i >> 2) + 2t + (i & 1), row + 8 ((i >> 1) & 1)
    assert "8 * (i >> 2) + (i & 1) < k_end" in LONG_SRC
    assert "o[4 * j + 2 * r] / den, o[4 * j + 2 * r + 1] / den" in LONG_SRC
    for warp in range(4):
        for lane in range(32):
            for i, (row, col) in enumerate(_wgmma_d(warp, lane, 64)):
                assert col == 8 * (i >> 2) + 2 * (lane % 4) + (i & 1)
                assert row == 16 * warp + lane // 4 + 8 * ((i >> 1) & 1)


# ---------------------------------------------------------------------------
# Operand routes: strided views and in-place output, no copies
# ---------------------------------------------------------------------------


def _bshd(B, S, H, dh, seed, strided):
    """[B, S, H, dh] float32 from seed, contiguous or a permuted view of
    [B, H, S, dh] storage."""
    x = _np((B, H, S, dh), seed)
    return _t(x).permute(0, 2, 1, 3) if strided else _t(np.ascontiguousarray(x.transpose(0, 2, 1, 3)))


@pytest.mark.parametrize("strided", [False, True])
def test_routes_equal_contiguous_copies_and_jax(strided):
    """span_attention_heads on permuted views, dispatch.dense_attention and
    ops.span_attention_op (every head live) give exactly what
    span_attention gives on contiguous [BH, S, dh] copies, and match the
    JAX functions within atol 2e-5."""
    B, S, H, dh = 2, 48, 3, 16
    q, k, v = (_bshd(B, S, H, dh, s, strided) for s in (1, 2, 3))
    flat = [x.permute(0, 2, 1, 3).reshape(B * H, S, dh).contiguous() for x in (q, k, v)]
    kv = torch.tensor([S, 17], dtype=torch.int32)

    # dense attention (the serving route): window = S, kv_len per batch row
    got = dispatch.dense_attention(q, k, v, causal=False, kv_len=kv)
    want = span_k.span_attention(*flat, torch.full((B * H,), S, dtype=torch.int32), S, causal=False,
                                 kv_lens=kv.repeat_interleave(H))
    assert torch.equal(got, want.reshape(B, H, S, dh).permute(0, 2, 1, 3))
    jax_want = np.concatenate([
        np.asarray(jdispatch.dense_attention(*(jnp.asarray(x[b:b + 1].numpy()) for x in (q, k, v)),
                                             causal=False, kv_len=int(kv[b])))
        for b in range(B)])
    np.testing.assert_allclose(got.numpy(), jax_want, atol=2e-5, rtol=0)

    # the deployed route with every head live (spans differ per head)
    spans = [5, 20, 11]
    for causal in (False, True):
        got = ops.span_attention_op(q, k, v, spans, causal=causal)
        want = span_k.span_attention(*flat, torch.tensor(spans * B, dtype=torch.int32), max(spans),
                                     causal=causal)
        assert torch.equal(got, want.reshape(B, H, S, dh).permute(0, 2, 1, 3))
        jax_want = jops.span_attention_op(*(jnp.asarray(x.numpy()) for x in (q, k, v)), spans,
                                          causal=causal, bq=32, bk=32)
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_want), atol=2e-5, rtol=0)

    # the heads wrapper itself, into a given output view
    out = torch.empty(B, S, H, dh).permute(0, 2, 1, 3)
    res = span_k.span_attention_heads(*(x.permute(0, 2, 1, 3) for x in (q, k, v)),
                                      torch.tensor(spans, dtype=torch.int32), max(spans),
                                      causal=True, out=out)
    assert res is out
    want = span_k.span_attention(*flat, torch.tensor(spans * B, dtype=torch.int32), max(spans), causal=True)
    assert torch.equal(out, want.reshape(B, H, S, dh))


class _Copies(TorchDispatchMode):
    """Records every op that writes a new tensor of at least ``numel``
    elements other than by allocating one or by taking a view."""

    ALLOC = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
             torch.ops.aten.empty_like.default}

    def __init__(self, numel):
        super().__init__()
        self.numel, self.ops, self.paused = numel, [], False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.paused and not func.is_view and func not in self.ALLOC:
            if any(isinstance(o, torch.Tensor) and o.numel() >= self.numel for o in tree_flatten(out)[0]):
                self.ops.append(str(func))
        return out


@pytest.mark.parametrize("route", ["dense_attention", "span_attention_op"])
def test_strided_route_copies_nothing(route, monkeypatch):
    """Around the kernel call, with KV == H and every head live, the route
    copies none of q, k, v or the output: the kernel gets views of the
    caller's tensors and writes into the tensor the route returns."""
    B, S, H, dh = 2, 40, 4, 16
    q, k, v = (_bshd(B, S, H, dh, s, False) for s in (4, 5, 6))
    mode = _Copies(q.numel())
    seen = []
    real = span_k.span_attention_heads

    def kernel(q_, k_, v_, spans, window, *, causal, kv_lens=None, out=None):
        seen.append((q_, k_, v_, out))
        mode.paused = True
        try:
            return real(q_, k_, v_, spans, window, causal=causal, kv_lens=kv_lens, out=out)
        finally:
            mode.paused = False

    monkeypatch.setattr(span_k, "span_attention_heads", kernel)
    with mode:
        if route == "dense_attention":
            res = dispatch.dense_attention(q, k, v, causal=False, kv_len=torch.tensor([S, 9], dtype=torch.int32))
        else:
            res = ops.span_attention_op(q, k, v, [8, 8, 3, 8], causal=False)
    assert mode.ops == []
    (q_, k_, v_, out), = seen
    for view, src in ((q_, q), (k_, k), (v_, v)):
        assert view.data_ptr() == src.data_ptr() and view.stride() == src.permute(0, 2, 1, 3).stride()
    assert out.data_ptr() == res.data_ptr() and res.is_contiguous() and res.shape == (B, S, H, dh)


@pytest.mark.parametrize("form", ["per_head", "per_lane", "scalar_expanded", "one_by_h", "b_by_one", "b_by_h",
                                  "b_by_h_transposed"])
def test_per_row_tables(form):
    """The spans and kv_lens the launcher reads: a tensor and the (batch,
    head) element strides that lay it out as the [B, H] table, from each
    form the callers pass, without a copy; the table equals the broadcast."""
    B, H = 3, 4
    base = torch.arange(1, B * H + 1, dtype=torch.int32).reshape(B, H)
    t, per_head = {
        "per_head": (base[0], True),
        "per_lane": (base[:, 0].contiguous(), False),
        "scalar_expanded": (torch.tensor(7, dtype=torch.int32).reshape(-1).expand(B), False),
        "one_by_h": (base[:1], True),
        "b_by_one": (base[:, :1], False),
        "b_by_h": (base, True),
        "b_by_h_transposed": (base.t().contiguous().t(), True),
    }[form]
    want = (t[None, :] if per_head else t[:, None]) if t.dim() == 1 else t
    got, strides = span_k._per_row(t, B, H, per_head, "spans")
    assert got is t
    assert torch.equal(got.as_strided((B, H), strides), want.expand(B, H))


def test_per_row_refuses_other_shapes_and_dtypes():
    with pytest.raises(TypeError):
        span_k._per_row(torch.ones(4, dtype=torch.int64), 3, 4, True, "spans")
    for bad in (torch.ones(5, dtype=torch.int32), torch.ones(2, 4, dtype=torch.int32),
                torch.ones(3, 4, 1, dtype=torch.int32)):
        with pytest.raises(ValueError):
            span_k._per_row(bad, 3, 4, True, "spans")
    assert span_k._per_row(None, 3, 4, True, "spans") is None

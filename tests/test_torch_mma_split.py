"""The arithmetic of the tensor-core matmul kernels, on the CPU.

csrc/af_matmul.cu and csrc/block_sparse.cu compute float32 products on bf16
tensor cores (csrc/split_mma.cuh): float32 x splits exactly into three bf16
terms, AdaptivFloat codes decode exactly into bf16, and the block-sparse
weights are packed once into three bf16 planes in mma.sync fragment order.
These tests check each of those facts here, where no card is, and hold a
float64 emulation of each kernel's sum of exact bf16 products against the
JAX package's Pallas kernel run in interpret mode.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.adaptivfloat import AFFormat as JAFFormat
from repro.core.adaptivfloat import af_encode as j_af_encode
from repro.kernels import block_sparse as jbs
from repro.kernels.adaptivfloat_k import af_matmul as j_af_matmul
from repro_torch.core.adaptivfloat import AFFormat, af_decode, af_encode
from repro_torch.kernels import block_sparse, build


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _binade_edges(n_per_side=64, k_range=(-20, 20)):
    """Every float32 within ``n_per_side`` ulp of 2**k, both signs (as
    chip_smoke.py binade_edges makes them)."""
    out = []
    for k in range(k_range[0], k_range[1] + 1):
        c = np.float32(2.0 ** k).view(np.int32)
        out.append(np.arange(c - n_per_side, c + n_per_side + 1, dtype=np.int32).view(np.float32))
    v = np.concatenate(out)
    return np.concatenate([v, -v])


def _assert_exact_split(x: torch.Tensor):
    x0, x1, x2 = block_sparse.split_bf16(x)
    assert x0.dtype == x1.dtype == x2.dtype == torch.bfloat16
    # the sum in float64 is exact; it must give x back bit for bit
    back = (x0.double() + x1.double() + x2.double()).float()
    assert torch.equal(back.view(torch.int32), x.view(torch.int32))
    # and so must the float32 sum small terms first, as the kernels add
    assert torch.equal((x2.float() + x1.float()) + x0.float(), x)


@pytest.mark.parametrize("seed,spread", [(0, 0), (1, 30), (2, 100)])
def test_split_is_exact_on_random_float32(seed, spread):
    """2^18 normal values times 2^e, e uniform in [-spread, spread]."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(1 << 18) * np.exp2(rng.integers(-spread, spread + 1, 1 << 18))
    _assert_exact_split(_t(x.astype(np.float32)))


def test_split_is_exact_at_binade_edges():
    """Every float32 within 64 ulp of 2**k, k in [-60, 60]: the values where
    a bf16 rounding carries into the next binade."""
    _assert_exact_split(_t(_binade_edges(64, (-60, 60))))


def _kernel_bf16x2(lo: np.ndarray, hi: np.ndarray, e_min: int, n_bits: int, n_exp: int):
    """csrc/af_matmul.cu af_bf16x2 on two codes in one 32-bit word, as
    __byte_perm leaves them (each code in both bytes of its half)."""
    n_mant = n_bits - 1 - n_exp
    lo, hi = lo.astype(np.uint64), hi.astype(np.uint64)
    v = lo | (lo << 8) | (hi << 16) | (hi << 24)
    sign_mask = (1 << (n_bits - 1)) * 0x00010001
    mag_mask = ((1 << (n_bits - 1)) - 1) * 0x00010001
    ebias2 = ((e_min + 127) << 7) * 0x00010001
    sign = ((v & sign_mask) << (16 - n_bits)) & 0xFFFFFFFF
    mag = v & mag_mask
    nz = ((((mag + 0x7FFF7FFF) & 0xFFFFFFFF) >> 15) & 0x00010001) * 0xFFFF
    bits = ((((mag << (7 - n_mant)) + ebias2) & 0xFFFFFFFF) & nz) | sign
    return (bits & 0xFFFF).astype(np.uint16), (bits >> 16).astype(np.uint16)


@pytest.mark.parametrize("n_bits,n_exp", [(8, 1), (8, 2), (8, 3), (8, 4), (6, 2), (4, 1)])
def test_every_af_code_decodes_exactly_into_bf16(n_bits, n_exp):
    """For e_min in [-30, 10] (the ALBERT weights' AF(8, 3) biases lie in
    [-12, 6]): every code's decoded float32 value is exact in bf16, and the
    kernel's bit construction, on every pair of codes in one register, gives
    those bf16 bits."""
    fmt = AFFormat(n_bits, n_exp)
    codes = np.arange(1 << n_bits, dtype=np.uint8)
    lo, hi = np.meshgrid(codes, codes, indexing="ij")
    lo, hi = lo.reshape(-1), hi.reshape(-1)
    for e_min in range(-30, 11):
        val = af_decode(_t(codes), e_min, fmt)
        bits = val.view(torch.int32).numpy()
        assert (bits & 0xFFFF == 0).all()                       # exact in bf16
        assert torch.equal(val.to(torch.bfloat16).float(), val)
        want = (bits >> 16).astype(np.uint16)
        got_lo, got_hi = _kernel_bf16x2(lo, hi, e_min, n_bits, n_exp)
        np.testing.assert_array_equal(got_lo, want[lo])
        np.testing.assert_array_equal(got_hi, want[hi])


@pytest.mark.parametrize("m,k,n", [(33, 130, 67), (16, 96, 3), (64, 256, 128)])
def test_af_matmul_split_emulation_matches_pallas(m, k, n):
    """float64 emulation of the kernel's arithmetic -- x2@W + x1@W + x0@W
    with every bf16 product exact -- within rtol 1e-5 + atol 1e-5 of the
    Pallas kernel (the tolerance test_torch_kernels.py holds the port's
    af_matmul to); ragged M, K and N included."""
    w = _np((k, n), 7, 1.0 / np.sqrt(k))
    x = _np((m, k), 8)
    jcodes, je = j_af_encode(jnp.asarray(w), JAFFormat())
    codes, e_min = af_encode(_t(w))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    want = np.asarray(j_af_matmul(jnp.asarray(x), jcodes, je, bm=32, bk=32, bn=32))
    W = af_decode(codes, int(e_min))
    assert torch.equal(W.to(torch.bfloat16).float(), W)
    terms = block_sparse.split_bf16(_t(x))
    emu = sum(t.double() @ W.double() for t in reversed(terms))
    np.testing.assert_allclose(emu.numpy(), want, rtol=1e-5, atol=1e-5)


def _fragment_positions():
    """(packed position, k, n) of a 32 x 32 tile, from the PTX description
    of the m16n8k16 B fragment: lane (g, t) holds, for k16 step ks and n8
    tile j, register b0 = (k 2t, 2t+1; col g) and b1 = (k 2t+8, 2t+9; col g),
    the lower k in the low half; the packing stores the registers lane by
    lane, tile by tile, step by step."""
    rows = []
    for ks in range(2):
        for j in range(4):
            for lane in range(32):
                g, t = lane // 4, lane % 4
                for slot, dk in enumerate((0, 1, 8, 9)):
                    p = ((ks * 4 + j) * 32 + lane) * 4 + slot
                    rows.append((p, 16 * ks + 2 * t + dk, 8 * j + g))
    return np.array(rows)


def _pruned(K, N, bk, bn, seed):
    mask = np.random.default_rng(seed).random((K // bk, N // bn)) < 0.5
    mask[:, 0] = True
    mask[:, (N // bn) // 2] = False          # an n-block with no occupied tile
    w = _np((K, N), seed + 1, 1.0 / np.sqrt(K)) * np.repeat(np.repeat(mask, bk, 0), bn, 1)
    return mask, w.astype(np.float32)


def _unpacked_planes(index, K, N):
    """The packed planes scattered back to three dense [K, N] float32
    weights, through the independent fragment map above."""
    pos = _fragment_positions()
    idx, cnt = index.indices.numpy(), index.counts.numpy()
    planes = np.zeros((3, K, N), np.float32)
    tiles = index.tiles.float().numpy()
    t = 0
    for j, c in enumerate(cnt):
        for s in range(c):
            k0, n0 = idx[j, s] * index.bk, j * index.bn
            tile = np.zeros((3, 32, 32), np.float32)
            tile[:, pos[:, 1], pos[:, 2]] = tiles[:, t, pos[:, 0]]
            assert not tile[:, index.bk:, :].any() and not tile[:, :, index.bn:].any()
            planes[:, k0:k0 + index.bk, n0:n0 + index.bn] = tile[:, :index.bk, :index.bn]
            t += 1
    assert t == tiles.shape[1] == index.occupied
    return planes


@pytest.mark.parametrize("K,N,bk,bn,seed", [(128, 96, 32, 32, 0), (96, 64, 16, 32, 1),
                                            (64, 64, 32, 16, 2), (192, 256, 32, 32, 3)])
def test_packed_tiles_rebuild_w(K, N, bk, bn, seed):
    """The packed planes, read in the index's CSR order through the
    fragment map, rebuild w bit for bit on the occupied tiles (zero padding
    elsewhere); the index itself equals the JAX package's."""
    mask, w = _pruned(K, N, bk, bn, seed)
    index = block_sparse.BlockIndex.build(mask, bk, bn, "cpu", w=_t(w))
    for got, want in zip(block_sparse.build_block_index(mask), jbs.build_block_index(mask)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert index.tiles.dtype == torch.bfloat16 and index.tiles.shape == (3, int(mask.sum()), 1024)
    np.testing.assert_array_equal(index.offsets.numpy(),
                                  np.concatenate([[0], np.cumsum(mask.sum(axis=0))[:-1]]))
    planes = _unpacked_planes(index, K, N)
    rebuilt = planes[2] + planes[1] + planes[0]
    # equal as floats: bitwise on every nonzero, and a pruned -0.0 (a
    # negative weight times a zero mask) rebuilds as +0.0
    np.testing.assert_array_equal(rebuilt, w)
    nz = w != 0
    np.testing.assert_array_equal(rebuilt.view(np.int32)[nz], w.view(np.int32)[nz])


@pytest.mark.parametrize("M,K,N,bk,bn", [(200, 128, 96, 32, 32), (37, 64, 128, 32, 32),
                                         (130, 96, 64, 16, 32), (5, 64, 64, 32, 16)])
def test_block_sparse_split_emulation_matches_pallas(M, K, N, bk, bn):
    """float64 emulation of the kernel's six-term sum over the packed planes,
    sum of x_i @ w_j for i + j <= 2, within rtol 1e-5 + atol 1e-5 of the
    Pallas kernel; ragged M and an n-block with no occupied tile."""
    mask, w = _pruned(K, N, bk, bn, M)
    x = _np((M, K), 2)
    want = np.asarray(jbs.block_sparse_matmul(jnp.asarray(x), jnp.asarray(w), mask,
                                              bm=128, bk=bk, bn=bn, interpret=True))
    planes = _unpacked_planes(block_sparse.BlockIndex.build(mask, bk, bn, "cpu", w=_t(w)), K, N)
    xs = [t.double().numpy() for t in block_sparse.split_bf16(_t(x))]
    emu = sum(xs[i] @ planes[j].astype(np.float64)
              for i in range(3) for j in range(3) if i + j <= 2)
    np.testing.assert_allclose(emu, want, rtol=1e-5, atol=1e-5)
    empty = (N // bn) // 2
    assert (emu[:, empty * bn:(empty + 1) * bn] == 0).all()


def test_index_from_the_mask_alone_has_no_tiles():
    """Without the weight the index has no packed tiles (the kernel refuses
    it); the plain version on the CPU still runs from it."""
    mask, w = _pruned(64, 64, 32, 32, 4)
    index = block_sparse.BlockIndex.build(mask, 32, 32, "cpu")
    assert index.tiles is None and index.offsets is None
    x = _np((3, 64), 5)
    got = block_sparse.block_sparse_matmul(_t(x), _t(w), index).numpy()
    np.testing.assert_allclose(got, x @ w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("change", ["none", "copy", "in_place", "view", "dtype"])
def test_index_checks_its_weight(change):
    """The kernel reads an index's packed tiles, not w, so the index takes
    only the weight they were packed from, unmodified: a copy, an in-place
    update, another view or another dtype raises."""
    mask, w = _pruned(64, 64, 32, 32, 6)
    wt = _t(w)
    index = block_sparse.BlockIndex.build(mask, 32, 32, "cpu", w=wt)
    other = {"none": lambda: wt, "copy": wt.clone, "view": lambda: wt.t(),
             "dtype": lambda: wt.to(torch.bfloat16),
             "in_place": lambda: wt.add_(1.0)}[change]()
    if change == "none":
        index.check_weight(other)
    else:
        with pytest.raises(ValueError):
            index.check_weight(other)


@pytest.mark.parametrize("blocks,k_steps,slots,want", [
    (96, 24, 132, 1),     # af_matmul, M = 2048, N = 768: one wave already
    (6, 24, 132, 8),      # M = 128, N = 768
    (24, 96, 132, 4),     # M = 512, N = 768
    (1, 2, 132, 2),       # no more blocks than k-steps
    (192, 48, 264, 1),    # block_sparse w_down, M = 1024
    (96, 48, 264, 2),     # ... M = 512
    (48, 48, 264, 4),     # ... M = 256
])
def test_cluster_split(blocks, k_steps, slots, want):
    assert build.cluster_split(blocks, k_steps, slots) == want

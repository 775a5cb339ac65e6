"""The serving step's two new kernels and its dispatch, port against the JAX
package.

On the CPU every wrapper takes its plain PyTorch version, held here against
the Pallas kernel run in interpret mode (as tests/test_kernels.py runs it):
the activation ``quantize`` (one bias per lane, as the JAX serving step's
``vmap`` over lanes gives it), the block-sparse MLP matmul, the static
block masks and their CSR index, magnitude pruning at the config's 32x32
block size, and the span kernel at full window with per-lane ``kv_len``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core.adaptivfloat import AFFormat as JAFFormat
from repro.core.pruning import magnitude_mask as j_magnitude_mask
from repro.kernels import block_sparse as jbs
from repro.kernels import dispatch as jdispatch
from repro.kernels.adaptivfloat_k import quantize as j_quantize
from repro_torch.core.adaptivfloat import AFFormat, floor_log2
from repro_torch.core.pruning import magnitude_mask
from repro_torch.kernels import block_sparse, dispatch, ops, ref
from repro_torch.kernels.adaptivfloat_k import group_exp_bias, quantize, quantize_groups


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _near_binade_edges(n_per_side=64, k_range=(-20, 20)):
    """Every float32 within ``n_per_side`` ulp of 2**k, both signs."""
    out = []
    for k in range(k_range[0], k_range[1] + 1):
        c = np.float32(2.0 ** k).view(np.int32)
        bits = np.arange(c - n_per_side, c + n_per_side + 1, dtype=np.int32)
        out.append(bits.view(np.float32))
    v = np.concatenate(out)
    return np.concatenate([v, -v])


def _lanes(seed, lanes, S, d, length_of):
    """[lanes, S, d] activations whose padded rows (beyond each lane's
    length) hold real values, some of them the lane's largest."""
    x = _np((lanes, S, d), seed, 2.0)
    for lane in range(lanes):
        n = length_of(lane)
        if n < S and lane % 2 == 0:
            x[lane, n:] *= 8.0         # the amax sits in the bucket padding
    return x


@pytest.mark.parametrize("fmt", [(8, 3), (8, 4), (6, 2)])
def test_quantize_per_lane_bit_exact(fmt):
    """Bit-exact (atol 0): the port quantizes all lanes in one call with one
    bias per lane; the JAX package quantizes each lane's whole padded
    [S, d] slab on its own (its serving step's vmap)."""
    lanes, S, d = 4, 16, 48
    x = _lanes(0, lanes, S, d, lambda lane: 5 + 3 * lane)
    edges = _near_binade_edges(8, (-3, 3))            # 238 values near 2**k
    x[1, :5].reshape(-1)[: len(edges)] = edges
    want = np.asarray(jax.vmap(lambda xl: j_quantize(xl, fmt=JAFFormat(*fmt), block_rows=8))(
        jnp.asarray(x)))
    got = dispatch.act_quantize(_t(x), *fmt, groups=lanes).numpy()
    np.testing.assert_array_equal(got, want)
    # the per-lane bias really differs between lanes here
    e_min = group_exp_bias(_t(x.reshape(lanes * S, d)), S, AFFormat(*fmt))
    assert len(set(e_min.tolist())) > 1


def test_quantize_binade_edges_bit_exact():
    """Every float32 within 64 ulp of 2**k, one row group per k, each with
    its own bias: the floor(log2) each value's binade comes from must land
    where XLA's does.  k runs over [-5, 12], where every exponent of a
    group's grid, k - 7 to k, lies in the range over which XLA's CPU exp2 is
    exact (ROADMAP Queue 3); chip_smoke.py covers k in [-20, 20] on the card
    against the port's own plain version."""
    d = 32
    groups = [np.concatenate([e, np.zeros((-len(e)) % d, np.float32)]).reshape(-1, d)
              for e in (_near_binade_edges(64, (k, k)) for k in range(-5, 13))]
    rows = groups[0].shape[0]
    want = np.concatenate(np.asarray(jax.vmap(lambda g: j_quantize(g, fmt=JAFFormat(8, 3)))(
        jnp.asarray(np.stack(groups)))))
    v = _t(np.concatenate(groups))
    e_min = group_exp_bias(v, rows)
    assert e_min.tolist() == [k - 7 for k in range(-5, 13)]
    np.testing.assert_array_equal(quantize(v, e_min, rows).numpy(), want)
    np.testing.assert_array_equal(ref.quantize(v, e_min, rows).numpy(), want)


@pytest.mark.parametrize("fmt", [(8, 3), (8, 4), (6, 2)])
@pytest.mark.parametrize("lanes,S,d", [(4, 16, 48), (3, 5, 33), (1, 32, 64)])
def test_quantize_groups_matches_jax(fmt, lanes, S, d):
    """quantize_groups, the serving path's one launch: its e_min equals
    group_exp_bias, and its output is bit-exact (atol 0) to the JAX
    package's act_quantize on each lane alone (its serving step's vmap),
    amax in the padding included."""
    x = _lanes(1 + S, lanes, S, d, lambda lane: 2 + 3 * lane)
    edges = _near_binade_edges(4, (-2, 2))            # 90 values near 2**k
    x[0, :3].reshape(-1)[: len(edges)] = edges[: 3 * d]
    want = np.asarray(jax.vmap(lambda xl: jdispatch.act_quantize(xl, *fmt))(jnp.asarray(x)))
    got, e_min = quantize_groups(_t(x.reshape(lanes * S, d)), S, fmt=AFFormat(*fmt))
    np.testing.assert_array_equal(got.numpy().reshape(x.shape), want)
    assert e_min.dtype == torch.int32 and e_min.shape == (lanes,)
    assert torch.equal(e_min, group_exp_bias(_t(x.reshape(lanes * S, d)), S, AFFormat(*fmt)))


def test_floor_log2_away_from_binade_edges_is_the_exponent():
    """What csrc/af_quantize.cu's grouped kernel rests on: a float32 whose
    mantissa field lies at least 4096 ulp (kEdgeUlps) from both ends of its
    binade has floor(log(x) * f32(1/ln 2)), taken with the CPU's float32
    log as the plain version takes it, equal to its exponent field, so the
    kernel reads the exponent there instead of taking a double log.  Every
    exponent of the normal range, every mantissa within 2048 ulp beyond each
    cut-off, and 4096 random mantissas between them."""
    edge, span = 4096, 2048
    rng = np.random.default_rng(11)
    mants = np.concatenate([np.arange(edge, edge + span), np.arange(2 ** 23 - edge - span, 2 ** 23 - edge + 1),
                            rng.integers(edge, 2 ** 23 - edge, 4096)]).astype(np.int64)
    for lo in range(1, 255, 32):
        expo = np.arange(lo, min(lo + 32, 255), dtype=np.int64)
        bits = (expo[:, None] << 23) | mants[None, :]
        x = torch.from_numpy(bits.astype(np.uint32).view(np.float32))
        got = floor_log2(x).numpy()
        np.testing.assert_array_equal(got, np.broadcast_to((expo - 127)[:, None], got.shape).astype(np.float32))


def test_quantize_rejects_rows_that_do_not_split():
    with pytest.raises(ValueError, match="groups"):
        dispatch.act_quantize(torch.zeros(3, 5, 8), 8, 3, groups=2)
    with pytest.raises(ValueError, match="groups of"):
        group_exp_bias(torch.zeros(10, 4), 3)
    with pytest.raises(ValueError, match="groups of"):
        quantize_groups(torch.zeros(10, 4), 3)


def _pruned_mask(Kb, Nb, seed, empty_col=True):
    m = np.random.default_rng(seed).random((Kb, Nb)) < 0.5
    m[:, 0] = True
    if empty_col:
        m[:, Nb // 2] = False          # an n-block with no occupied tile
    return m


@pytest.mark.parametrize("M,K,N,bk,bn", [(200, 128, 96, 32, 32), (37, 64, 128, 32, 32),
                                         (130, 96, 64, 16, 32), (5, 64, 64, 32, 16)])
def test_block_sparse_matmul_matches_pallas(M, K, N, bk, bn):
    """rtol 1e-5 + atol 1e-5 (float32 sums in another order), on a ragged M
    and a mask with an n-block that has no occupied tile (zeros out)."""
    mask = _pruned_mask(K // bk, N // bn, M)
    w = _np((K, N), 1) * np.repeat(np.repeat(mask, bk, 0), bn, 1).astype(np.float32)
    x = _np((M, K), 2)
    want = np.asarray(jbs.block_sparse_matmul(jnp.asarray(x), jnp.asarray(w), mask,
                                              bm=128, bk=bk, bn=bn, interpret=True))
    index = block_sparse.BlockIndex.build(mask, bk, bn, "cpu")
    got = block_sparse.block_sparse_matmul(_t(x), _t(w), index).numpy()
    assert got.dtype == np.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    empty = N // bn // 2
    assert (got[:, empty * bn:(empty + 1) * bn] == 0).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_block_index_equal(seed):
    mask = _pruned_mask(6, 9, seed)
    for got, want in zip(block_sparse.build_block_index(mask), jbs.build_block_index(mask)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert block_sparse.build_block_index(np.zeros((3, 2), bool))[2] == 1


@pytest.mark.parametrize("shape,block,sparsity", [((256, 512), 32, 0.5), ((512, 256), 32, 0.5),
                                                  ((96, 80), 32, 0.3), ((64, 48), 1, 0.5)])
def test_magnitude_mask_equal(shape, block, sparsity):
    w = _np(shape, 3)
    want = np.asarray(j_magnitude_mask(jnp.asarray(w), sparsity, block_size=block))
    got = magnitude_mask(_t(w), sparsity, block_size=block).numpy()
    np.testing.assert_array_equal(got, want)


def test_mlp_block_masks_equal():
    """The static masks (and the CSR index beside them) from pruned weights;
    fully occupied weights map to None on both sides."""
    d, ff = 64, 256
    w_up = _np((d, ff), 4)
    w_down = _np((ff, d), 5)
    w_up = w_up * np.asarray(j_magnitude_mask(jnp.asarray(w_up), 0.5, block_size=32))
    mlp = {"w_up": w_up, "w_down": w_down}
    want = jdispatch.mlp_block_masks({k: jnp.asarray(v) for k, v in mlp.items()})
    got = dispatch.mlp_block_masks({k: _t(v) for k, v in mlp.items()})
    assert want["w_down"] is None and got["w_down"] is None
    occ, bk, bn = want["w_up"]
    np.testing.assert_array_equal(got["w_up"].mask, occ)
    assert (got["w_up"].bk, got["w_up"].bn) == (bk, bn) == (32, 32)
    idx, cnt, nnz = jbs.build_block_index(occ)
    np.testing.assert_array_equal(got["w_up"].indices.numpy(), idx)
    np.testing.assert_array_equal(got["w_up"].counts.numpy(), cnt)
    assert got["w_up"].max_nnz == nnz
    # the dispatch matmul over the mask equals the dense product
    x = _np((3, 5, d), 6)
    np.testing.assert_allclose(dispatch.sparse_matmul(_t(x), _t(w_up), got["w_up"]).numpy(),
                               x @ w_up, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S", [16, 32])
def test_dense_attention_kv_len_matches_pallas(S):
    """The serving step's attention: full window, per-lane kv_len (the JAX
    package takes one lane at a time, a scalar kv_len each); atol 2e-5."""
    B, H, dh = 3, 4, 16
    q, k, v = _np((B, S, H, dh), 7), _np((B, S, H, dh), 8), _np((B, S, H, dh), 9)
    kv = np.array([S, S // 2 + 1, 3], np.int32)
    want = np.concatenate([
        np.asarray(jdispatch.dense_attention(jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]),
                                             jnp.asarray(v[b:b + 1]), causal=False,
                                             kv_len=int(kv[b])))
        for b in range(B)
    ])
    got = dispatch.dense_attention(_t(q), _t(k), _t(v), causal=False, kv_len=_t(kv)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_serving_wrappers_count_no_launch_on_the_cpu():
    ops.reset_launch_counts()
    x = torch.randn(2, 8, 64)
    dispatch.act_quantize(x, 8, 3, groups=2)
    mask = np.ones((2, 2), bool)
    mask[0, 1] = False
    dispatch.sparse_matmul(x, torch.randn(64, 64), block_sparse.BlockIndex.build(mask, 32, 32, "cpu"))
    assert set(ops.launch_counts()) == set(ops.KERNEL_WRAPPERS)
    assert set(ops.SERVING_KERNELS) <= set(ops.KERNEL_WRAPPERS)
    assert all(n == 0 for n in ops.launch_counts().values())

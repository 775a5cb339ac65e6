// Block-sparse matmul: out[M, N] = x[M, K] @ w[K, N] over w's occupied
// (bk x bn) tiles only, fp32 in and out, on bf16 tensor cores with float32
// parity.
//
// Replaces the Pallas kernel repro/kernels/block_sparse.py:42 _bs_kernel
// (pallas_call at :84).  As there, a CSR-of-blocks index built on the host
// (kernels/block_sparse.py build_block_index: for each n-block the occupied
// k-block indices, padded to max_nnz, and their count) drives the k-loop,
// so pruned tiles are never read and never multiplied.  The TPU kernel walks
// the index as a sequential grid axis through scalar prefetch; here each
// block reads its own n-block's count and indices and loops over them.
//
// The weights are not read as float32.  When the index is built from the
// weights (BlockIndex.build(..., w=), once per weight when the server is
// built), each occupied tile is split exactly into three bf16 planes,
// w = w0 + w1 + w2 (split_mma.cuh), zero-padded to 32 x 32 and stored in
// the index's CSR order in mma.sync B-fragment order: one contiguous 2 KB
// chunk per tile and plane, from which each lane loads its fragments with
// one 8-byte shared load per n8 tile.  x is split the same way in
// registers, and the six products x_i @ w_j with i + j <= 2 (the dropped
// ones are at most ~2^-26 of |x||w|) are summed small terms first into a fresh
// tensor-core accumulator per tile, promoted into the float32 accumulator
// with a round-to-nearest add.
//
// Design: one 256-thread block per (128-row m-tile, n-block), 8 warps of
// 16 rows x 32 columns; the occupied tiles stream through a 4-stage ring of
// {x[128, 32] fp32, three packed planes} in dynamic shared memory, filled by
// 16-byte cp.async (rows of x that are not 16-byte aligned, K % 4 or
// bk % 4 != 0, take synchronous scalar loads).  When the grid has fewer
// blocks than two per SM, an n-block's occupied list is split over a
// cluster of up to 8 blocks and the partial tiles are summed through
// distributed shared memory in rank order: no atomics, the same bits on
// every launch (an unsplit grid is launched as clusters of one block).
// An n-block with no occupied tile writes zeros; rows past M
// are masked.  bk and bn are at most 32 (the serving masks use 32 x 32
// tiles, configs/base.py PruneConfig.block_size).
//
// Bound on the H100 at the serving shapes (M = 1024 = 8 lanes x 128;
// 768 x 3072 and 3072 x 768 at 50% tile occupancy): operations, ~2.4 GFLOP
// of fp32 work per matrix over the occupied tiles (~36 us at 67 TFLOP/s),
// or 6 bf16 passes of it on the tensor cores (~15 us at 989 TFLOP/s),
// against ~22 MB moved (~7 us).
#include "split_mma.cuh"

namespace {

using namespace split_mma;

constexpr int BM = 128;
constexpr int TILE = 32;          // packed tile edge; bk and bn are at most this
constexpr int STAGES = 4;
constexpr int kThreads = 256;
constexpr int XS = TILE + 8;      // x tile row stride (floats): conflict-free float2 reads
constexpr int PS = TILE + 1;      // partial tile row stride (floats)
constexpr int X_BYTES = BM * XS * 4;
constexpr int PLANE_BYTES = TILE * TILE * 2;
constexpr int STAGE_BYTES = X_BYTES + 3 * PLANE_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
static_assert(X_BYTES % 16 == 0 && STAGE_BYTES % 16 == 0, "cp.async needs 16-byte alignment");
static_assert(BM * PS * 4 <= SMEM_BYTES, "the partial tile reuses the ring");

bool g_opted_in[64];   // per device

__global__ void __launch_bounds__(kThreads, 2)
block_sparse_kernel(float* __restrict__ out, const float* __restrict__ x,
                    const uint16_t* __restrict__ tiles, const int* __restrict__ indices,
                    const int* __restrict__ counts, const int* __restrict__ offsets, int M, int K,
                    int N, int bk, int bn, int max_nnz, long plane_tiles, int x_vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = split_size(), rank = split_rank();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nb = blockIdx.x;
  const int m0 = blockIdx.y * BM, n0 = nb * bn;

  // this block's slice of the n-block's occupied tiles
  const int nnz = counts[nb];
  const int s0 = rank * nnz / S, ns = (rank + 1) * nnz / S - s0;
  const int* idx = indices + static_cast<long>(nb) * max_nnz;
  const long tile0 = offsets[nb];
  const int ksteps = bk > 16 ? 2 : 1;

  auto load_stage = [&](int buf, int s) {
    float* xs = reinterpret_cast<float*>(smem + buf * STAGE_BYTES);
    unsigned char* ws = smem + buf * STAGE_BYTES + X_BYTES;
    const int k0 = idx[s] * bk;
    if (x_vec) {
#pragma unroll
      for (int i = 0; i < (BM * TILE / 4) / kThreads; ++i) {
        const int q = tid + i * kThreads, row = q >> 3, c = (q & 7) * 4;
        const int gm = m0 + row;
        const bool ok = gm < M && c < bk;
        cp_async16(xs + row * XS + c, x + (ok ? static_cast<long>(gm) * K + k0 + c : 0), ok ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < (BM * TILE) / kThreads; ++i) {
        const int e = tid + i * kThreads, row = e >> 5, c = e & 31;
        const int gm = m0 + row;
        xs[row * XS + c] = (gm < M && c < bk) ? x[static_cast<long>(gm) * K + k0 + c] : 0.f;
      }
    }
    for (int q = tid; q < 3 * PLANE_BYTES / 16; q += kThreads) {
      const int plane = q / (PLANE_BYTES / 16), off = (q % (PLANE_BYTES / 16)) * 8;
      cp_async16(ws + plane * PLANE_BYTES + off * 2,
                 tiles + (plane * plane_tiles + tile0 + s) * (TILE * TILE) + off, 16);
    }
  };

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;

  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < ns) load_stage(p, s0 + p);
    cp_async_commit();
  }

  for (int it = 0; it < ns; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int pre = it + STAGES - 1;
    if (pre < ns) load_stage(pre % STAGES, s0 + pre);
    cp_async_commit();

    const float* xs = reinterpret_cast<const float*>(smem + (it % STAGES) * STAGE_BYTES);
    const unsigned char* ws = smem + (it % STAGES) * STAGE_BYTES + X_BYTES;
    float tc[4][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      if (ks >= ksteps) break;
      const float* xr = xs + (16 * warp + g) * XS + ks * 16 + 2 * t;
      const float2 v00 = *reinterpret_cast<const float2*>(xr);
      const float2 v10 = *reinterpret_cast<const float2*>(xr + 8 * XS);
      const float2 v01 = *reinterpret_cast<const float2*>(xr + 8);
      const float2 v11 = *reinterpret_cast<const float2*>(xr + 8 * XS + 8);
      uint32_t x0[4], x1[4], x2[4];
      split3(v00.x, v00.y, x0[0], x1[0], x2[0]);
      split3(v10.x, v10.y, x0[1], x1[1], x2[1]);
      split3(v01.x, v01.y, x0[2], x1[2], x2[2]);
      split3(v11.x, v11.y, x0[3], x1[3], x2[3]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // this lane's B fragments of n8 tile j in each plane (fragment order)
        uint32_t w[3][2];
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          const uint2 v = *reinterpret_cast<const uint2*>(
              ws + p * PLANE_BYTES + (((ks * 4 + j) * 32 + lane) * 4) * 2);
          w[p][0] = v.x;
          w[p][1] = v.y;
        }
        if (ks == 0) {
          mma_zero(tc[j], x2, w[0]);
        } else {
          mma(tc[j], x2, w[0]);
        }
        mma(tc[j], x1, w[1]);
        mma(tc[j], x0, w[2]);
        mma(tc[j], x1, w[0]);
        mma(tc[j], x0, w[1]);
        mma(tc[j], x0, w[0]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) promote(acc[j], tc[j]);
  }
  cp_async_wait<0>();
  __syncthreads();

  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      part[(16 * warp + g + 8 * (r >> 1)) * PS + 8 * j + 2 * t + (r & 1)] = acc[j][r];
  reduce_store(part, BM, bn, PS, [&](int r, int c, float v) {
    const int gm = m0 + r;
    if (gm < M) out[static_cast<long>(gm) * N + n0 + c] = v;
  });
}

}  // namespace

// Dynamic shared memory per block (the ring), for the build report.
REPRO_EXPORT int repro_smem_bytes() { return SMEM_BYTES; }

// x [M, K] fp32; tiles [3, plane_tiles, 32 * 32] bf16 bits (the occupied
// tiles in CSR order, kernels/block_sparse.py pack_tiles); indices
// [N / bn, max_nnz], counts and offsets (first tile of each n-block in
// `tiles`) [N / bn] int32.  K and N must be multiples of bk and bn, both in
// [1, 32].  Each n-block's occupied list is split over clusters of `split`
// (1..8) blocks.
REPRO_EXPORT int repro_block_sparse_matmul(float* out, const float* x, const uint16_t* tiles,
                                           const int* indices, const int* counts,
                                           const int* offsets, int M, int K, int N, int bk,
                                           int bn, int max_nnz, int plane_tiles, int split,
                                           void* stream, int device) {
  const DeviceScope scope(device);
  cudaError_t err = scope.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bk < 1 || bk > TILE || bn < 1 || bn > TILE || K % bk != 0 || N % bn != 0 || split < 1 ||
      split > 8 || M < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  const int x_vec = (K % 4 == 0) && (bk % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const dim3 grid(N / bn, (M + BM - 1) / BM, split);
  return static_cast<int>(split_mma::launch_split(
      block_sparse_kernel, grid, kThreads, SMEM_BYTES, static_cast<cudaStream_t>(stream), device,
      g_opted_in, out, x, tiles, indices, counts, offsets, M, K, N, bk, bn, max_nnz,
      static_cast<long>(plane_tiles), x_vec));
}

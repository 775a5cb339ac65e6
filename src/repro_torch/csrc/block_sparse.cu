// Block-sparse matmul: out[M, N] = x[M, K] @ w[K, N] over w's occupied
// (bk x bn) tiles only, fp32 accumulate, fp32 out.
//
// Replaces the Pallas kernel repro/kernels/block_sparse.py:42 _bs_kernel
// (pallas_call at :84).  As there, a CSR-of-blocks index built on the host
// (kernels/block_sparse.py build_block_index: for each n-block the occupied
// k-block indices, padded to max_nnz, and their count) drives the k-loop,
// so pruned tiles are never read and never multiplied.  The TPU kernel walks
// the index as a sequential grid axis through scalar prefetch; here each
// block reads its own n-block's count and indices and loops over them.
//
// Design: one 256-thread block per (64-row m-tile, n-block).  Per occupied
// k-block it stages the 64 x bk slice of x and the bk x bn tile of w in
// shared memory and each thread accumulates a 4 x 2 patch of outputs with
// fp32 FMAs.  An n-block with no occupied tile writes zeros; rows past M are
// masked on load and store.  bk and bn are at most 32 (the serving masks use
// 32 x 32 tiles, configs/base.py PruneConfig.block_size).
//
// Bound on the H100 at the serving shapes (M = 1024 = 8 lanes x 128;
// 768 x 3072 and 3072 x 768 at ~50% tile occupancy): operations, ~2.4 GFLOP
// of fp32 FMA per matrix over the occupied tiles (~36 us at 67 TFLOP/s)
// against ~22 MB moved (~7 us).  The scalar FMAs and the shared-memory
// reads they wait on stand where a later PR would put register-blocked or
// tensor-core tiles.
#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int TILE = 32;          // largest bk and bn the kernel takes
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
block_sparse_kernel(float* __restrict__ out, const float* __restrict__ x,
                    const float* __restrict__ w, const int* __restrict__ indices,
                    const int* __restrict__ counts, int M, int K, int N, int bk, int bn,
                    int max_nnz) {
  __shared__ float xs[BM][TILE + 1];
  __shared__ float ws[TILE][TILE];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int nb = blockIdx.x;
  const int m0 = blockIdx.y * BM, n0 = nb * bn;
  const int nnz = counts[nb];
  float acc[4][2] = {};

  for (int s = 0; s < nnz; ++s) {
    const int k0 = indices[nb * max_nnz + s] * bk;
    __syncthreads();                       // previous tile consumed
#pragma unroll
    for (int r = 0; r < (BM * TILE) / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int row = e / TILE, c = e % TILE;
      const int gm = m0 + row;
      xs[row][c] = (c < bk && gm < M) ? x[static_cast<long>(gm) * K + k0 + c] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < (TILE * TILE) / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int kr = e / TILE, c = e % TILE;
      ws[kr][c] = (kr < bk && c < bn) ? w[static_cast<long>(k0 + kr) * N + n0 + c] : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < bk; ++kk) {
      float a[4], b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 2; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = tx + 16 * j;
      if (c < bn) out[static_cast<long>(gm) * N + n0 + c] = acc[i][j];
    }
  }
}

}  // namespace

// x [M, K], w [K, N] fp32; indices [N / bn, max_nnz], counts [N / bn] int32.
// K and N must be multiples of bk and bn, both in [1, 32].
REPRO_EXPORT int repro_block_sparse_matmul(float* out, const float* x, const float* w,
                                           const int* indices, const int* counts, int M,
                                           int K, int N, int bk, int bn, int max_nnz,
                                           void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bk < 1 || bk > TILE || bn < 1 || bn > TILE || K % bk != 0 || N % bn != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  const dim3 grid(N / bn, (M + BM - 1) / BM);
  block_sparse_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, x, w, indices, counts, M, K, N, bk, bn, max_nnz);
  return static_cast<int>(cudaGetLastError());
}

// fp32-exact products on bf16 tensor cores, shared by af_matmul.cu,
// block_sparse.cu and span_attention.cu.
//
// Every float32 x is exactly x0 + x1 + x2 of three bf16 values:
// x0 = bf16(x), x1 = bf16(x - x0), x2 = bf16(x - x0 - x1) (round to nearest
// each time; both differences are exact in float32, and the last residual
// has at most 8 significant bits, so x2 is exact).  A product of two bf16
// values is exact in float32, so x @ W for a W that is exact in bf16 is the
// sum of three bf16 tensor-core products, x0@W + x1@W + x2@W, and only the
// order of the float32 accumulation differs from an fp32 SGEMM.
//
// The tensor cores' float32 accumulation aligns to the largest term and
// truncates; it is not IEEE round to nearest.  The kernels therefore sum
// each 32-deep k-step's passes (small terms first) into a fresh tensor-core
// accumulator and then promote it into a separate float32 accumulator with
// an ordinary round-to-nearest add, so the truncation never compounds over K.
//
// Here: the split, mma.sync m16n8k16 (bf16 in, f32 accumulate) with its
// fragment layouts, ldmatrix.trans, 16-byte cp.async with zero fill, and
// split-K over a thread-block cluster: its reduction and the cluster launch.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <string.h>

#include "common.cuh"

namespace split_mma {

// ---------------------------------------------------------------------------
// The exact three-way split, two values at a time (one bf16x2 register each)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

// (lo, hi) -> three bf16x2 registers with lo in the low half, as mma.sync
// packs two consecutive k of one row.  Every step is an explicit _rn
// intrinsic, so nvcc cannot contract the subtractions into anything inexact.
__device__ __forceinline__ void split3(float lo, float hi, uint32_t& p0, uint32_t& p1,
                                       uint32_t& p2) {
  const __nv_bfloat162 b0 = __floats2bfloat162_rn(lo, hi);
  const float2 f0 = __bfloat1622float2(b0);
  const float r1lo = __fsub_rn(lo, f0.x), r1hi = __fsub_rn(hi, f0.y);
  const __nv_bfloat162 b1 = __floats2bfloat162_rn(r1lo, r1hi);
  const float2 f1 = __bfloat1622float2(b1);
  const __nv_bfloat162 b2 = __floats2bfloat162_rn(__fsub_rn(r1lo, f1.x), __fsub_rn(r1hi, f1.y));
  p0 = bf16x2_bits(b0);
  p1 = bf16x2_bits(b1);
  p2 = bf16x2_bits(b2);
}

// ---------------------------------------------------------------------------
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
//
// With g = lane / 4 and t = lane % 4:
//   A (16 x 16, row): a[0] = (row g,   k 2t..2t+1)   a[1] = (row g+8, k 2t..2t+1)
//                     a[2] = (row g,   k 2t+8..2t+9) a[3] = (row g+8, k 2t+8..2t+9)
//   B (16 x 8, col):  b[0] = (k 2t..2t+1, col g)     b[1] = (k 2t+8..2t+9, col g)
//   C (16 x 8):       c[0..1] = (row g, col 2t..2t+1)  c[2..3] = (row g+8, col 2t..2t+1)
// the lower k (or col) in the low half of each register.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The same with a zero accumulator in: starts a k-step's tensor-core sum.
__device__ __forceinline__ void mma_zero(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  const float z = 0.f;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(z));
}

// acc += tc with round-to-nearest float32 adds (the promotion).
template <int N>
__device__ __forceinline__ void promote(float (&acc)[N], const float (&tc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = __fadd_rn(acc[i], tc[i]);
}

// ldmatrix.sync.aligned.m8n8.x4.shared.b16: lanes 8i..8i+7 give the 16-byte
// rows 0..7 of 8 x 8 bf16 matrix i, and register ri receives matrix i: lane
// (g, t) gets (row g, col 2t) in the low half and (row g, col 2t+1) in the
// high half.  For a row-major [m][k] operand that is the A fragment above:
// matrices (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15),
// (rows 8-15, k 8-15) give a[0..3].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16: lanes 8i..8i+7 give the
// 16-byte rows 0..7 of 8 x 8 bf16 matrix i, and register ri receives matrix
// i transposed: lane (g, t) gets (row 2t, col g) in the low half and (row
// 2t+1, col g) in the high half.  For a row-major [k][n] operand that is
// the B fragment above: rows k 0..7 of an n8 tile give b[0], rows 8..15 b[1].
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(s)
               : "memory");
}

// ---------------------------------------------------------------------------
// cp.async: 16-byte global -> shared copies; src_bytes < 16 zero-fills the
// rest (0 reads nothing, but the address must still be a valid one)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Split-K over a thread-block cluster
//
// Every launch is a grid of clusters of (1, 1, grid.z) blocks: the S =
// grid.z blocks of a cluster each sum one slice of K (S = 1 when the grid
// fills the card).  Every block leaves its [rows x cols] partial tile in
// shared memory (row stride `ld` floats).  Unsplit, the block stores it.
// Split, after cluster.sync() rank r sums rows [r*rows/S, (r+1)*rows/S) of
// all S partials through distributed shared memory, always in rank order
// 0, 1, ..., S-1, and stores them: no atomics, so a result is the same bit
// for bit on every launch.  The second cluster.sync() keeps every block's
// shared memory alive until all remote reads are done.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int split_size() {
  return static_cast<int>(cooperative_groups::this_cluster().num_blocks());
}

__device__ __forceinline__ int split_rank() {
  return static_cast<int>(cooperative_groups::this_cluster().block_rank());
}

template <typename Store>
__device__ __forceinline__ void reduce_store(float* part, int rows, int cols, int ld, Store store) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  if (S == 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < rows * cols; e += blockDim.x)
      store(e / cols, e % cols, part[(e / cols) * ld + e % cols]);
  } else {
    const int rank = static_cast<int>(cluster.block_rank());
    cluster.sync();
    const int r0 = rank * rows / S, r1 = (rank + 1) * rows / S;
    for (int e = threadIdx.x; e < (r1 - r0) * cols; e += blockDim.x) {
      const int r = r0 + e / cols, c = e % cols;
      float s = *cluster.map_shared_rank(part + r * ld + c, 0);
      for (int q = 1; q < S; ++q) s = __fadd_rn(s, *cluster.map_shared_rank(part + r * ld + c, q));
      store(r, c, s);
    }
    cluster.sync();
  }
}

// Launch `kernel` with `smem` bytes of dynamic shared memory as clusters of
// (1, 1, grid.z) blocks.  Shared memory above 48 KB needs an opt-in per
// function and device (`opted_in`) before the first launch, or the launch
// is refused.
template <typename... Params, typename... Args>
cudaError_t launch_split(void (*kernel)(Params...), dim3 grid, int threads, int smem,
                         cudaStream_t stream, int device, bool* opted_in, Args... args) {
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!opted_in[device]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in[device] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = grid.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace split_mma

// AF8-weight matmul: out[M, N] = x[M, K] @ decode(codes[K, N], e_min), fp32.
//
// Replaces the Pallas kernel repro/kernels/adaptivfloat_k.py:99
// _af_matmul_kernel (pallas_call at :141, per-tile decode _decode_tile at
// :87).  The weights stay uint8 AdaptivFloat codes in device memory, one byte
// per weight read; each block stages an x tile and a code tile in shared
// memory and decodes the codes there:
//   code [s | e (n_exp) | m (n_mant)] -> (-1)^s * 2^(e + e_min) * (1 + m / 2^n_mant),
//   with e = m = 0 decoding to (signed) zero.
// 2^(e + e_min) is built from the exponent bits, so the decode is exact and
// equal bit for bit to repro_torch.core.adaptivfloat.af_decode.
//
// Bound on the H100 at the main path's shapes (M = 2048; K x N = 768 x 768,
// 768 x 3072, 3072 x 768): operations.  w_up is 9.7 GFLOP of fp32 FMA
// (~145 us at the 67 TFLOP/s fp32 rate outside the tensor cores) against
// ~34 MB moved (~10 us).  Design: a plain shared-memory SGEMM, 64 x 64 output
// tile per 256-thread block, 4 x 4 outputs per thread, k-tiles of 16; ragged
// edges are masked on load and store, nothing is padded.  Tensor cores
// (TF32 or bf16 wgmma) would break the fp32 parity this path is held to and
// are for a later PR.
#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int kThreads = 256;

// 2^e for integer e in [-126, 127], exactly.
__device__ __forceinline__ float exact_pow2(int e) {
  return __int_as_float((e + 127) << 23);
}

__device__ __forceinline__ float af_decode_one(unsigned c, int e_min, int n_bits,
                                               int n_exp) {
  const int n_mant = n_bits - 1 - n_exp;
  const unsigned sign = (c >> (n_bits - 1)) & 1u;
  const unsigned e_field = (c >> n_mant) & ((1u << n_exp) - 1u);
  const unsigned m_field = c & ((1u << n_mant) - 1u);
  float val = 0.f;
  if (e_field != 0u || m_field != 0u) {
    const float frac = 1.0f + static_cast<float>(m_field) / static_cast<float>(1 << n_mant);
    val = exact_pow2(static_cast<int>(e_field) + e_min) * frac;
  }
  return sign ? -val : val;
}

__global__ void __launch_bounds__(kThreads)
af_matmul_kernel(float* __restrict__ out, const float* __restrict__ x,
                 const uint8_t* __restrict__ codes, int M, int K, int N, int e_min,
                 int n_bits, int n_exp) {
  __shared__ float xs[BK][BM + 4];   // x tile, transposed (k-major)
  __shared__ uint8_t cs[BK][BN];     // raw code tile
  __shared__ float ws[BK][BN];       // decoded weight tile

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int r = 0; r < (BM * BK) / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int mr = e / BK, kc = e % BK;
      const int gm = m0 + mr, gk = k0 + kc;
      xs[kc][mr] = (gm < M && gk < K) ? x[static_cast<long>(gm) * K + gk] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < (BK * BN) / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int kr = e / BN, nc = e % BN;
      const int gk = k0 + kr, gn = n0 + nc;
      cs[kr][nc] = (gk < K && gn < N) ? codes[static_cast<long>(gk) * N + gn] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < (BK * BN) / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int kr = e / BN, nc = e % BN;
      ws[kr][nc] = af_decode_one(cs[kr][nc], e_min, n_bits, n_exp);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) out[static_cast<long>(gm) * N + gn] = acc[i][j];
    }
  }
}

}  // namespace

REPRO_EXPORT int repro_af_matmul(float* out, const float* x, const uint8_t* codes,
                                 int M, int K, int N, int e_min, int n_bits, int n_exp,
                                 void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M == 0 || N == 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  af_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, x, codes, M, K, N, e_min, n_bits, n_exp);
  return static_cast<int>(cudaGetLastError());
}

// Row LayerNorm with fused gamma/beta (paper §V-D3, Eq. 5).
//
// Replaces the Pallas kernel repro/kernels/layernorm.py:17 _layernorm_kernel
// (pallas_call at :44).  Same math: fp32 sums of x and x*x over the row,
// var = E[X^2] - E[X]^2, y = (x - mean) * rsqrt(var + eps) * gamma + beta.
//
// Bound on the H100 at the main path's shape ([2048, 768] fp32): bytes.  It
// reads the row once and writes it once (12.6 MB in all, ~3.8 us at
// 3.35 TB/s) for ~8 flops per element.  Design: one warp per row, eight rows
// per 256-thread block; lanes stride the row so every load is a coalesced
// 128-byte line.  The second pass re-reads the row from L1/L2 rather than
// holding it in registers, which keeps any d legal; a register-resident row
// and 16-byte loads are for a later PR.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
layernorm_kernel(float* __restrict__ out, const float* __restrict__ x,
                 const float* __restrict__ gamma, const float* __restrict__ beta,
                 int rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* xr = x + row * d;
  float s = 0.f, sq = 0.f;
  for (int j = lane; j < d; j += 32) {
    const float v = xr[j];
    s += v;
    sq += v * v;
  }
  s = warp_sum(s);
  sq = warp_sum(sq);
  const float mean = s / static_cast<float>(d);
  const float var = sq / static_cast<float>(d) - mean * mean;
  const float inv = rsqrtf(var + eps);
  float* orow = out + row * d;
  for (int j = lane; j < d; j += 32) {
    orow[j] = (xr[j] - mean) * inv * gamma[j] + beta[j];
  }
}

}  // namespace

REPRO_EXPORT int repro_layernorm(float* out, const float* x, const float* gamma,
                                 const float* beta, int rows, int d, float eps,
                                 void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0) return 0;
  const dim3 grid((rows + kWarps - 1) / kWarps);
  layernorm_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      out, x, gamma, beta, rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

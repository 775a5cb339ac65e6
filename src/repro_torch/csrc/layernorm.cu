// Row LayerNorm with fused gamma/beta (paper §V-D3, Eq. 5).
//
// Replaces the Pallas kernel repro/kernels/layernorm.py:17 _layernorm_kernel
// (pallas_call at :44).  Same math: fp32 sums of x and x*x over the row,
// var = E[X^2] - E[X]^2, y = (x - mean) * rsqrt(var + eps) * gamma + beta.
//
// Bound on the H100 at the main path's shape ([2048, 768] fp32): bytes.  It
// reads the row once and writes it once (12.6 MB in all, ~3.8 us at
// 3.35 TB/s) for ~8 flops per element; at the serving shapes (256-1024
// rows) the bound is 0.5-1.9 us, so launch latency and the host's cost per
// call are what remain.  Design:
//   * one warp per row, the row held in registers as float4: d/128 vectors
//     per lane (6 at d = 768), one 16-byte load and one 16-byte store per
//     vector, neighbouring lanes on neighbouring addresses; the moments come
//     from the registers, so x is read once;
//   * gamma and beta loaded as float4 once per warp and kept in registers
//     while the warp walks its rows;
//   * blocks of 1, 2 or 4 warps, chosen so the grid covers the SMs from 256
//     rows up; one warp per row up to 64 warps per SM (all the SM holds at
//     once), beyond which each warp walks several rows;
//   * d that is not a multiple of 128 or above 1024 (the smoke configs' 64,
//     the MLP's 3072: a row and gamma/beta would no longer fit in registers),
//     or unaligned pointers, take a generic path in the same kernel: lanes
//     stride the row with scalar loads, the second pass re-reads it.
#include "common.cuh"

namespace {

template <int VEC>   // float4 vectors per lane (d = 128 * VEC, at most 8); 0 = any d
__global__ void __launch_bounds__(128)
layernorm_kernel(float* __restrict__ out, const float* __restrict__ x,
                 const float* __restrict__ gamma, const float* __restrict__ beta,
                 int rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x >> 5);
  const long first = static_cast<long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if constexpr (VEC > 0) {
    float4 gv[VEC], bv[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      gv[i] = reinterpret_cast<const float4*>(gamma)[lane + 32 * i];
      bv[i] = reinterpret_cast<const float4*>(beta)[lane + 32 * i];
    }
    for (long row = first; row < rows; row += warps) {
      const float4* xr = reinterpret_cast<const float4*>(x + row * d);
      float4* orow = reinterpret_cast<float4*>(out + row * d);
      float4 v[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = xr[lane + 32 * i];
      float s = 0.f, sq = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s += v[i].x + v[i].y + v[i].z + v[i].w;
        sq += v[i].x * v[i].x + v[i].y * v[i].y + v[i].z * v[i].z + v[i].w * v[i].w;
      }
      s = warp_sum(s);
      sq = warp_sum(sq);
      const float mean = s / static_cast<float>(d);
      const float var = sq / static_cast<float>(d) - mean * mean;
      const float inv = rsqrtf(var + eps);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float4 g = gv[i], b = bv[i];
        float4 y;
        y.x = (v[i].x - mean) * inv * g.x + b.x;
        y.y = (v[i].y - mean) * inv * g.y + b.y;
        y.z = (v[i].z - mean) * inv * g.z + b.z;
        y.w = (v[i].w - mean) * inv * g.w + b.w;
        orow[lane + 32 * i] = y;
      }
    }
  } else {
    for (long row = first; row < rows; row += warps) {
      const float* xr = x + row * d;
      float* orow = out + row * d;
      float s = 0.f, sq = 0.f;
      for (int j = lane; j < d; j += 32) {
        const float a = xr[j];
        s += a;
        sq += a * a;
      }
      s = warp_sum(s);
      sq = warp_sum(sq);
      const float mean = s / static_cast<float>(d);
      const float var = sq / static_cast<float>(d) - mean * mean;
      const float inv = rsqrtf(var + eps);
      for (int j = lane; j < d; j += 32) orow[j] = (xr[j] - mean) * inv * gamma[j] + beta[j];
    }
  }
}

int g_sms[64];   // streaming multiprocessors, per device (0 = not queried yet)

}  // namespace

// x, out [rows, d] fp32 contiguous; gamma, beta [d].
REPRO_EXPORT int repro_layernorm(float* out, const float* x, const float* gamma,
                                 const float* beta, int rows, int d, float eps,
                                 void* stream, int device) {
  if (device < 0 || device >= 64 || rows < 0 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const DeviceScope scope(device);
  cudaError_t err = scope.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0) return 0;
  if (g_sms[device] == 0) {
    err = cudaDeviceGetAttribute(&g_sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int sms = g_sms[device];
  const int wpb = rows >= 4 * sms ? 4 : rows >= 2 * sms ? 2 : 1;
  const int warps = rows < 64 * sms ? rows : 64 * sms;
  const dim3 grid((warps + wpb - 1) / wpb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
                         reinterpret_cast<uintptr_t>(gamma) | reinterpret_cast<uintptr_t>(beta)) & 15) == 0;
  const int vec = aligned && d % 128 == 0 ? d / 128 : 0;
#define REPRO_LN(V) layernorm_kernel<V><<<grid, wpb * 32, 0, s>>>(out, x, gamma, beta, rows, d, eps)
  switch (vec) {
    case 1: REPRO_LN(1); break;
    case 2: REPRO_LN(2); break;
    case 3: REPRO_LN(3); break;
    case 4: REPRO_LN(4); break;
    case 5: REPRO_LN(5); break;
    case 6: REPRO_LN(6); break;
    case 7: REPRO_LN(7); break;
    case 8: REPRO_LN(8); break;
    default: REPRO_LN(0); break;
  }
#undef REPRO_LN
  return static_cast<int>(cudaGetLastError());
}

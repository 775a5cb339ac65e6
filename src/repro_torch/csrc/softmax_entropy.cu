// Fused row softmax + entropy (paper Alg. 1 + Eq. 4, the GB unit).
//
// Replaces the Pallas kernel repro/kernels/softmax_entropy.py:17
// _sm_ent_kernel (pallas_call at :48).  Same math: z = x - max(x),
// e = exp(z), s = sum(e); probs = e / s * mask (the mask is multiplied in
// and NOT renormalised); entropy = log(s) - sum(z * e) / s of the unmasked
// distribution, clamped at 0.  A null mask means all ones.
//
// Bound on the H100 at the main path's shape ([16, 3] off-ramp logits):
// bytes, and at 0.4 KB both bounds are far below the launch latency, which
// is what this kernel's time really measures.  Design: one warp per row,
// lanes stride the row; the exponentials are recomputed in the second pass
// instead of staged, so any row length is legal.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;

__global__ void __launch_bounds__(kWarps * 32)
softmax_entropy_kernel(float* __restrict__ probs, float* __restrict__ ent,
                       const float* __restrict__ x, const float* __restrict__ mask,
                       int rows, int n) {
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* xr = x + row * n;
  float m = -INFINITY;
  for (int j = lane; j < n; j += 32) m = fmaxf(m, xr[j]);
  m = warp_max(m);
  float s = 0.f, sz = 0.f;
  for (int j = lane; j < n; j += 32) {
    const float z = xr[j] - m;
    const float e = expf(z);
    s += e;
    sz += z * e;
  }
  s = warp_sum(s);
  sz = warp_sum(sz);
  float* pr = probs + row * n;
  for (int j = lane; j < n; j += 32) {
    float p = expf(xr[j] - m) / s;
    if (mask != nullptr) p *= mask[row * n + j];
    pr[j] = p;
  }
  if (lane == 0) ent[row] = fmaxf(logf(s) - sz / s, 0.f);
}

}  // namespace

REPRO_EXPORT int repro_softmax_entropy(float* probs, float* ent, const float* x,
                                       const float* mask, int rows, int n,
                                       void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0) return 0;
  const dim3 grid((rows + kWarps - 1) / kWarps);
  softmax_entropy_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      probs, ent, x, mask, rows, n);
  return static_cast<int>(cudaGetLastError());
}

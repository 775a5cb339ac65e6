// AdaptivFloat quantize-dequantize of activations, one bias per row group.
//
// Replaces the Pallas kernel repro/kernels/adaptivfloat_k.py:41
// _quantize_kernel (pallas_call at :68, body _quant_body at :22).  The
// serving step quantizes each lane's [S_bucket, D] hidden state with that
// lane's own bias (the JAX package vmaps the call over lanes), so the kernel
// takes one e_min per group of rows_per_group rows; the per-group amax and
// e_min are computed outside, as the JAX wrapper does.  Per element:
//   e   = clamp(floor(log2|x|), e_min, e_min + 2^n_exp - 1)
//   val = round_half_even(|x| / 2^e * 2^n_mant) / 2^n_mant * 2^e,
//   saturated at the top code, flushed to 0 below half the smallest
//   normal and raised to it above, signed.
//
// Bit-exactness: floor(log2) is taken as XLA lowers it on the CPU,
// floor(log(x) * f32(1/ln 2)), with the float32 log computed as
// (float)log((double)x).  CUDA's logf is not correctly rounded, and near a
// power of two a last-ulp difference moves the floor into the other binade
// (the quantum then jumps by 2x); the double form gives the same floor as
// the CPU plain version on every float32 within 64 ulp of 2^k.  Powers of
// two are built from the exponent bits, rounding is rintf (half to even,
// like jnp.round), and every product and quotient is an explicit _rn
// intrinsic so nvcc cannot contract them into FMAs.
//
// Bound on the H100 at the serving shape ([8 lanes x 128, 768] fp32): bytes.
// One read and one write of 3.1 MB each (~1.9 us at 3.35 TB/s) against
// ~30 float ops and one double log per element.  Design: a grid-stride
// elementwise pass, 256 threads a block, coalesced scalar loads; each thread
// reads its group's bias from global memory (cached).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// float32(1 / ln 2), the constant XLA multiplies log(x) by
constexpr float kInvLn2 = 1.44269502162933349609375f;

__device__ __forceinline__ float exact_pow2(int e) {
  return __int_as_float((e + 127) << 23);
}

__device__ __forceinline__ float floor_log2(float a) {
  const float lg = static_cast<float>(log(static_cast<double>(a)));
  return floorf(__fmul_rn(lg, kInvLn2));
}

__global__ void __launch_bounds__(kThreads)
af_quantize_kernel(float* __restrict__ out, const float* __restrict__ x,
                   const int* __restrict__ e_min, long n, long group_elems,
                   int n_mant, int n_levels_exp) {
  const float n_mant_scale = static_cast<float>(1 << n_mant);
  const float top = 2.0f - 1.0f / n_mant_scale;
  const float above_one = 1.0f + 1.0f / n_mant_scale;
  const long stride = static_cast<long>(gridDim.x) * blockDim.x;
  for (long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int e_lo = e_min[i / group_elems];
    const int e_hi = e_lo + (n_levels_exp - 1);
    const float v = x[i];
    const float a = fabsf(v);
    const float sign = v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
    const float safe_a = fmaxf(a, 1e-38f);
    const float e = fminf(fmaxf(floor_log2(safe_a), static_cast<float>(e_lo)),
                          static_cast<float>(e_hi));
    const float scale = exact_pow2(static_cast<int>(e));
    const float mant =
        __fdiv_rn(rintf(__fmul_rn(__fdiv_rn(a, scale), n_mant_scale)), n_mant_scale);
    float val = fminf(__fmul_rn(mant, scale), __fmul_rn(top, exact_pow2(e_hi)));
    const float min_pos = __fmul_rn(exact_pow2(e_lo), above_one);
    val = a < __fmul_rn(0.5f, min_pos) ? 0.f : fmaxf(val, min_pos);
    out[i] = __fmul_rn(sign, val);
  }
}

}  // namespace

// x, out: [rows, d] fp32; e_min: [ceil(rows / rows_per_group)] int32.
REPRO_EXPORT int repro_af_quantize(float* out, const float* x, const int* e_min, int rows,
                                   int d, int rows_per_group, int n_bits, int n_exp,
                                   void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long n = static_cast<long>(rows) * d;
  if (n == 0) return 0;
  if (rows_per_group <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long blocks_needed = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(blocks_needed < 132L * 16 ? blocks_needed : 132L * 16);
  af_quantize_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, x, e_min, n, static_cast<long>(rows_per_group) * d, n_bits - 1 - n_exp,
      1 << n_exp);
  return static_cast<int>(cudaGetLastError());
}

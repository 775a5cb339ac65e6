// Shared helpers for the port's kernels.  Each csrc/*.cu is compiled on its
// own into a shared library with a plain C interface (loaded with ctypes by
// repro_torch/kernels/build.py), so this header is included once per library.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

// Human-readable text for an error code returned by a launcher.
REPRO_EXPORT const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

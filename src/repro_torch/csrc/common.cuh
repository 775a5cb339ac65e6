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

// Makes `device` the calling thread's current device for a launcher's scope
// and sets back the device it found when the scope ends, on every return
// path: a launch for one card leaves PyTorch's notion of the current device
// as it was (a later allocation or stream query with no device named would
// otherwise land on the launch's card).  A launcher's return value is
// computed before the scope ends, so its cudaGetLastError() is unaffected.
class DeviceScope {
 public:
  explicit DeviceScope(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      changed_ = err_ == cudaSuccess;
    }
  }
  ~DeviceScope() {
    if (changed_) cudaSetDevice(prev_);
  }
  DeviceScope(const DeviceScope&) = delete;
  DeviceScope& operator=(const DeviceScope&) = delete;
  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  bool changed_ = false;
  cudaError_t err_ = cudaSuccess;
};

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

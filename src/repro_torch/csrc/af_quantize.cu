// AdaptivFloat quantize-dequantize of activations, one bias per row group.
//
// Replaces the Pallas kernel repro/kernels/adaptivfloat_k.py:41
// _quantize_kernel (pallas_call at :68, body _quant_body at :22) together
// with the amax and bias its wrapper `quantize` (:47-66) takes around it.
// The serving step quantizes each lane's [S_bucket, D] hidden state with
// that lane's own bias (the JAX package vmaps the call over lanes), so a
// group is rows_per_group rows.  Per group and element:
//   amax  = max |x| over the group
//   e_min = clamp(floor(log2(max(amax, 1e-30))) - (2^n_exp - 1), -120, 120)
//   e     = clamp(floor(log2|x|), e_min, e_min + 2^n_exp - 1)
//   val   = round_half_even(|x| / 2^e * 2^n_mant) / 2^n_mant * 2^e,
//   saturated at the top code, flushed to 0 below half the smallest
//   normal and raised to it above, signed.
//
// Two entry points:
//   repro_af_quantize_groups  amax, bias and quantize in one launch; also
//                             writes e_min [groups] (the serving path);
//   repro_af_quantize         the bias given per group (elementwise pass).
//
// Bit-exactness: floor(log2) is taken as XLA lowers it on the CPU,
// floor(log(x) * f32(1/ln 2)), with the float32 log computed as
// (float)log((double)x).  CUDA's logf is not correctly rounded, and near a
// power of two a last-ulp difference moves the floor into the other binade
// (the quantum then jumps by 2x); the double form gives the same floor as
// the CPU plain version on every float32 within 64 ulp of 2^k.  Powers of
// two are built from the exponent bits, rounding is rintf (half to even,
// like jnp.round), and every product is an explicit _rn intrinsic so nvcc
// cannot contract them into FMAs.  The divisions by powers of two are
// products with their exact reciprocals, which round the same exact
// quotient once and so give the same bits.
//
// Both entries take the double log only where it can change the floor
// (floor_log2_fast): a float32 whose mantissa field lies at least
// kEdgeUlps from both ends of its binade has floor(log2) equal to its
// exponent field in every rounding of the log the CPU may do.  The float32
// product log(x) * f32(1/ln 2) is within ~3 (|k| + 1) ulp of 2^-23 of
// log2(x) = k + log2(1 + m), and log2(1 + m) >= 1.44 m is at least 5909 of
// those ulp from k and from k + 1 at m = kEdgeUlps * 2^-23, against at most
// 384 for |k| <= 127.  tests/test_torch_serving_kernels.py checks the claim
// on the CPU's float32 log.  An element below 2^e_min clamps to e_min
// whatever its floor, so it needs no log either.
//
// Bound on the H100 at the serving shapes ([8 lanes x S_bucket, 768] fp32,
// S_bucket = 128 / 64 / 32): bytes.  One read and one write of the tensor,
// 2 x 3.1 / 1.6 / 0.8 MB: 1.88 / 0.94 / 0.47 us at 3.35 TB/s, against ~30
// float ops per element.  The chain this replaces launched ~11 PyTorch
// kernels for the amax and bias, then the elementwise pass.
//
// Design of the grouped kernel:
//   * one thread-block cluster per group; its blocks split the group's
//     elements and keep their share in registers (up to 16 floats a thread
//     of 1024, float4 loads where the group is 16-byte aligned);
//   * a block max by warp shuffles, then one cluster.sync() and every warp
//     reads the other blocks' maxima through distributed shared memory:
//     max is order-independent, so the bias is exact and the same on every
//     launch;
//   * every block computes e_min, quantizes from registers and writes once:
//     the tensor is read once and written once;
//   * a group too large for the cluster's registers is read twice, the
//     second time from L2;
//   * the cluster size is the largest power of two up to 8 that leaves
//     every block at least 1024 floats, keeps all groups' blocks within the
//     card's SMs and lets every cluster be resident at once
//     (cudaOccupancyMaxActiveClusters): 8 lanes x 8 blocks at the serving
//     shapes.  Clusters of 16 (non-portable) measured slower on the H100:
//     at 1024 threads only 7 fit at once, and at 512 threads two blocks of
//     a cluster may share an SM.
//   The kernel cannot overlap its loads with its stores (every store waits
//   for the group's amax), so its time is a launch, a full read, a cluster
//   barrier and a full write, one after the other.
#include "common.cuh"

#include <cooperative_groups.h>

namespace {

constexpr int kThreads = 256;            // elementwise kernel
constexpr int kGroupThreads = 1024;      // grouped kernel
constexpr int kGroupWarps = kGroupThreads / 32;
constexpr int kResident = 16;            // floats a thread keeps in registers
constexpr int kMaxCluster = 8;
constexpr long kMinBlockElems = 1024;    // a cluster block's least share of a group
constexpr uint32_t kEdgeUlps = 4096;     // see floor_log2_fast
// float32(1 / ln 2), the constant XLA multiplies log(x) by
constexpr float kInvLn2 = 1.44269502162933349609375f;

__device__ __forceinline__ float exact_pow2(int e) {
  return __int_as_float((e + 127) << 23);
}

__device__ __forceinline__ float floor_log2(float a) {
  const float lg = static_cast<float>(log(static_cast<double>(a)));
  return floorf(__fmul_rn(lg, kInvLn2));
}

// floor_log2 without the double log where it cannot change the result:
// normal floats whose mantissa field lies kEdgeUlps or more from either
// end of the binade (see the header).
__device__ __forceinline__ float floor_log2_fast(float a) {
  const uint32_t bits = __float_as_uint(a);
  const uint32_t mant = bits & 0x7fffffu, expo = bits >> 23;
  if (expo != 0u && mant >= kEdgeUlps && mant <= 0x7fffffu - kEdgeUlps)
    return static_cast<float>(static_cast<int>(expo) - 127);
  return floor_log2(a);
}

// The per-tensor bias from the group's amax (core/adaptivfloat.py
// exp_bias_from_amax).
__device__ __forceinline__ int bias_from_amax(float amax, int n_levels_exp) {
  const float b = floor_log2_fast(fmaxf(amax, 1e-30f)) - static_cast<float>(n_levels_exp - 1);
  return static_cast<int>(fminf(fmaxf(b, -120.f), 120.f));
}

// One element on the grid of bias e_lo.  An |x| below 2^e_lo clamps to
// e_lo whatever its floor (the computed floor is at most one above the
// true one), so it takes no log.  2^-e is a normal float for e <= 126;
// e = 127 divides.
__device__ __forceinline__ float quant(float v, int e_lo, int e_hi, float n_mant_scale) {
  const float a = fabsf(v);
  const float safe_a = fmaxf(a, 1e-38f);
  const float fl = safe_a < exact_pow2(e_lo) ? static_cast<float>(e_lo) : floor_log2_fast(safe_a);
  const int ei = static_cast<int>(fminf(fmaxf(fl, static_cast<float>(e_lo)), static_cast<float>(e_hi)));
  const float sign = v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
  const float top = 2.0f - 1.0f / n_mant_scale;
  const float above_one = 1.0f + 1.0f / n_mant_scale;
  const float scale = exact_pow2(ei);
  const float q = ei <= 126 ? __fmul_rn(a, exact_pow2(-ei)) : __fdiv_rn(a, scale);
  const float mant = __fmul_rn(rintf(__fmul_rn(q, n_mant_scale)), __frcp_rn(n_mant_scale));
  float val = fminf(__fmul_rn(mant, scale), __fmul_rn(top, exact_pow2(e_hi)));
  const float min_pos = __fmul_rn(exact_pow2(e_lo), above_one);
  val = a < __fmul_rn(0.5f, min_pos) ? 0.f : fmaxf(val, min_pos);
  return __fmul_rn(sign, val);
}

__global__ void __launch_bounds__(kThreads)
af_quantize_kernel(float* __restrict__ out, const float* __restrict__ x,
                   const int* __restrict__ e_min, long n, long group_elems,
                   int n_mant, int n_levels_exp) {
  const float n_mant_scale = static_cast<float>(1 << n_mant);
  const long stride = static_cast<long>(gridDim.x) * blockDim.x;
  for (long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int e_lo = e_min[i / group_elems];
    const int e_hi = e_lo + (n_levels_exp - 1);
    out[i] = quant(x[i], e_lo, e_hi, n_mant_scale);
  }
}

template <int VEC>
struct Chunk;
template <>
struct Chunk<4> {
  static __device__ __forceinline__ void get(const float* p, float* v) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
  static __device__ __forceinline__ void put(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Chunk<1> {
  static __device__ __forceinline__ void get(const float* p, float* v) { v[0] = *p; }
  static __device__ __forceinline__ void put(float* p, const float* v) { *p = v[0]; }
};

// grid (cluster, groups), clusters of (cluster, 1, 1) blocks: cluster rank r
// of group g owns units [r * per, (r + 1) * per) of the group's
// group_elems / VEC units of VEC floats.
template <int VEC>
__global__ void __launch_bounds__(kGroupThreads)
af_quantize_groups_kernel(float* __restrict__ out, int* __restrict__ e_min_out,
                          const float* __restrict__ x, long group_elems, int n_mant,
                          int n_levels_exp) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int U = kResident / VEC;     // units a thread holds

  const long units = group_elems / VEC;
  const long per = (units + cs - 1) / cs;
  const long u0 = rank * per;
  const long u1 = u0 + per < units ? u0 + per : units;
  const long g = blockIdx.y;
  const float* xg = x + g * group_elems;
  float* og = out + g * group_elems;
  const bool resident = u1 - u0 <= static_cast<long>(U) * kGroupThreads;

  float v[kResident];
  float m = 0.f;
  if (resident) {
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const long u = u0 + tid + static_cast<long>(j) * kGroupThreads;
      if (u < u1) {
        Chunk<VEC>::get(xg + u * VEC, v + j * VEC);
#pragma unroll
        for (int i = 0; i < VEC; ++i) m = fmaxf(m, fabsf(v[j * VEC + i]));
      }
    }
  } else {
    for (long u = u0 + tid; u < u1; u += kGroupThreads) {
      float t[VEC];
      Chunk<VEC>::get(xg + u * VEC, t);
#pragma unroll
      for (int i = 0; i < VEC; ++i) m = fmaxf(m, fabsf(t[i]));
    }
  }

  // block max, then the cluster's through distributed shared memory
  __shared__ float warp_max_s[kGroupWarps];
  __shared__ float block_max;
  m = warp_max(m);
  if (lane == 0) warp_max_s[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = warp_max(lane < kGroupWarps ? warp_max_s[lane] : 0.f);
    if (lane == 0) block_max = m;
  }
  cluster.sync();
  const float amax = warp_max(lane < cs ? *cluster.map_shared_rank(&block_max, lane) : 0.f);

  const int e_lo = bias_from_amax(amax, n_levels_exp);
  const int e_hi = e_lo + (n_levels_exp - 1);
  const float n_mant_scale = static_cast<float>(1 << n_mant);
  if (rank == 0 && tid == 0) e_min_out[g] = e_lo;

  if (resident) {
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const long u = u0 + tid + static_cast<long>(j) * kGroupThreads;
      if (u < u1) {
        float q[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) q[i] = quant(v[j * VEC + i], e_lo, e_hi, n_mant_scale);
        Chunk<VEC>::put(og + u * VEC, q);
      }
    }
  } else {
    for (long u = u0 + tid; u < u1; u += kGroupThreads) {
      float t[VEC];
      Chunk<VEC>::get(xg + u * VEC, t);
#pragma unroll
      for (int i = 0; i < VEC; ++i) t[i] = quant(t[i], e_lo, e_hi, n_mant_scale);
      Chunk<VEC>::put(og + u * VEC, t);
    }
  }
  // no block leaves while another may still read its block_max
  cluster.sync();
}

// Per device: SM count, and for each kernel instance (VEC 1 / 4) and
// cluster size 2^i the clusters the card holds at once (0 = not asked yet).
int g_sms[64];
int g_max_clusters[64][2][4];

template <int VEC>
cudaLaunchConfig_t group_config(int cs, int groups, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, groups, 1);
  cfg.blockDim = dim3(kGroupThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int VEC>
cudaError_t max_clusters(int device, int cs, int* n) {
  const int vi = VEC == 4, li = __builtin_ctz(static_cast<unsigned>(cs));
  if (g_max_clusters[device][vi][li] == 0) {
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = group_config<VEC>(cs, 1, nullptr, attr);
    int found = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveClusters(&found, af_quantize_groups_kernel<VEC>, &cfg);
    if (err != cudaSuccess) return err;
    g_max_clusters[device][vi][li] = found > 0 ? found : -1;
  }
  *n = g_max_clusters[device][vi][li];
  return cudaSuccess;
}

// The cluster size for `groups` groups of `group_elems` floats (header).
template <int VEC>
cudaError_t pick_cluster(int device, int groups, long group_elems, int* cs_out) {
  if (g_sms[device] == 0) {
    const cudaError_t err =
        cudaDeviceGetAttribute(&g_sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  int cs = 1;
  while (cs < kMaxCluster && static_cast<long>(groups) * cs * 2 <= g_sms[device] &&
         group_elems / (cs * 2) >= kMinBlockElems)
    cs *= 2;
  while (cs > 1) {
    int n = 0;
    const cudaError_t err = max_clusters<VEC>(device, cs, &n);
    if (err != cudaSuccess) return err;
    if (n >= groups) break;
    cs /= 2;
  }
  *cs_out = cs;
  return cudaSuccess;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x, out: [rows, d] fp32; e_min: [ceil(rows / rows_per_group)] int32.
REPRO_EXPORT int repro_af_quantize(float* out, const float* x, const int* e_min, int rows,
                                   int d, int rows_per_group, int n_bits, int n_exp,
                                   void* stream, int device) {
  const DeviceScope scope(device);
  cudaError_t err = scope.error();
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

// x, out: [rows, d] fp32 with rows = groups * rows_per_group; e_min_out:
// [groups] int32, each group's bias.
REPRO_EXPORT int repro_af_quantize_groups(float* out, int* e_min_out, const float* x, int rows,
                                          int d, int rows_per_group, int n_bits, int n_exp,
                                          void* stream, int device) {
  const DeviceScope scope(device);
  cudaError_t err = scope.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= 64 || rows_per_group <= 0 || d <= 0 || rows % rows_per_group)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = rows / rows_per_group;
  if (groups == 0) return 0;
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const long group_elems = static_cast<long>(rows_per_group) * d;
  const bool vec = group_elems % 4 == 0 && aligned16(x) && aligned16(out);
  const int n_mant = n_bits - 1 - n_exp, levels = 1 << n_exp;
  int cs = 0;
  cudaLaunchAttribute attr[1];
  if (vec) {
    err = pick_cluster<4>(device, groups, group_elems, &cs);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = group_config<4>(cs, groups, static_cast<cudaStream_t>(stream), attr);
    err = cudaLaunchKernelEx(&cfg, af_quantize_groups_kernel<4>, out, e_min_out, x, group_elems,
                             n_mant, levels);
  } else {
    err = pick_cluster<1>(device, groups, group_elems, &cs);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = group_config<1>(cs, groups, static_cast<cudaStream_t>(stream), attr);
    err = cudaLaunchKernelEx(&cfg, af_quantize_groups_kernel<1>, out, e_min_out, x, group_elems,
                             n_mant, levels);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Fused row softmax + entropy (paper Alg. 1 + Eq. 4, the GB unit), alone
// and as the last stage of the off-ramp head.
//
// Replaces the Pallas kernel repro/kernels/softmax_entropy.py:17
// _sm_ent_kernel (pallas_call at :48).  Same math: z = x - max(x),
// e = exp(z), s = sum(e); probs = e / s * mask (the mask is multiplied in
// and NOT renormalised); entropy = log(s) - sum(z * e) / s of the unmasked
// distribution, clamped at 0.  A null mask means all ones.
//
// Three entry points:
//   repro_softmax_entropy  given logits (+ mask): probs and entropy, one
//                          warp per row;
//   repro_entropy_rows     the entropy alone of rows of vocabulary width:
//                          the decode path's LM-head off-ramp
//                          (repro/models/model.py:939-947 through
//                          repro/kernels/dispatch.py:77-89, which throws the
//                          probs away), after every layer of every decode
//                          step;
//   repro_offramp_head     the whole off-ramp the paths run after a layer
//                          (repro/serving/step_math.py:85-92,
//                          repro/serving/deploy.py:97-103):
//                            pooled = tanh(h[:, 0, :] @ pooler_w + pooler_b)
//                            logits = pooled @ cls_w + cls_b
//                            ent    = entropy(softmax(logits))
//                            retire = active & (ent < threshold)
//                          into one packed fp32 row per sentence,
//                          [logits (C) | ent | retire as 1.0 / 0.0].  The
//                          weights are fp32, or AF8 uint8 codes with their
//                          per-tensor e_min, decoded exactly as
//                          csrc/af_matmul.cu does (one template).
//
// Bound on the H100 at the paths' shapes: bytes of the pooler weight.  The
// head reads it once: 2.36 MB fp32 at D = 768 (serving, 0.70 us at
// 3.35 TB/s) or 0.59 MB of codes (deployed, 0.18 us); its arithmetic is
// 2 B D^2 = 18.9 MFLOP at B = 16 (0.28 us at 67 TFLOP/s fp32).  At the
// [8-16, 3] logits alone the kernel's time is launch latency.
//
// Design of the head: a GEMV-shaped reduction spread over the card.
//   * block j owns pooler columns [8 j, 8 j + 8) for every sentence: 96
//     blocks at D = 768.  Its weight slice (D x 8, fp32 or codes) and the
//     CLS rows, 8 at a time for B <= 8 (serving) and 16 otherwise (read by
//     the batch stride: no copy of h), come into shared memory by
//     cp.async, all in flight together; codes are then decoded in shared
//     memory;
//   * 256 threads = 2 groups of 4 columns x 128 k-slices; each thread sums
//     its k-slice for its 4 columns and all rows of the chunk (a float4 of
//     weights per k, each CLS value used 4 times), the slices are reduced
//     by warp shuffles and then across warps in a fixed order, and the
//     block applies bias and tanh and forms its partial classifier sums
//     [B, C];
//   * the last block to finish (a counter, __threadfence) loads every
//     block's partials into shared memory at once, sums them in
//     block-index order (a fixed shuffle tree), adds the bias, and writes
//     softmax, entropy and retire: the same bits on every launch, whichever
//     block ends last.  It resets the counter for the next launch.  The
//     counter and scratch must not be shared by two launches that may run
//     at once: the wrapper keeps a pair per (device, stream).
//
// Bound of repro_entropy_rows on the H100 at the decode shape ([lanes, V]
// fp32, lanes 1-8, V = 102400): bytes.  One read of the logits, 4 x 102400
// x 4 B = 1.64 MB at 4 lanes (half that in bf16, the decoders' own dtype:
// read as bf16, computed in fp32): 0.49 us at 3.35 TB/s (0.12 us at 1 lane),
// below the card's empty launch; ~8 float ops per logit (3.3 MFLOP, 0.05
// us at 67 TFLOP/s).  The warp-per-row entry reads each 400 KB row three
// times from 4 warps on one SM and writes the probs nobody reads.
//
// Design of the wide-row entropy:
//   * one thread-block cluster per row (grid (cluster, rows)); the cluster
//     size is the largest power of two up to 8 that leaves each block at
//     least 4096 logits and keeps the grid within twice the card's SMs: 8
//     blocks of 256 threads per row at the decode shape, 32 blocks for 4
//     lanes;
//   * each block reads its contiguous share of the row once, 16-byte loads
//     where the row allows, four loads in flight per thread, and keeps a
//     one-pass triple (m, s, sz) = (running max, sum of e^z, sum of z e^z)
//     with z = x - m, rescaled when the max moves:
//         s' = e^(m - m') s,   sz' = e^(m - m') (sz + (m - m') s);
//   * triples merge by the same rule in a fixed shuffle tree within a
//     warp, across the block's warps, and across the cluster through
//     distributed shared memory (rank 0 reads every block's triple after a
//     cluster barrier): a fixed order, so every launch gives the same bits;
//   * rank 0 writes entropy = max(log(s) - sz / s, 0).  No probs are
//     written.
#include "common.cuh"

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;

// z, e and their sums over one row of n logits, held by one warp.
__device__ __forceinline__ void row_stats(const float* xr, int n, int lane, float& m, float& s,
                                          float& sz) {
  m = -INFINITY;
  for (int j = lane; j < n; j += 32) m = fmaxf(m, xr[j]);
  m = warp_max(m);
  s = 0.f;
  sz = 0.f;
  for (int j = lane; j < n; j += 32) {
    const float z = xr[j] - m;
    const float e = expf(z);
    s += e;
    sz += z * e;
  }
  s = warp_sum(s);
  sz = warp_sum(sz);
}

__device__ __forceinline__ float row_entropy(float s, float sz) {
  return fmaxf(logf(s) - sz / s, 0.f);
}

__global__ void __launch_bounds__(kWarps * 32)
softmax_entropy_kernel(float* __restrict__ probs, float* __restrict__ ent,
                       const float* __restrict__ x, const float* __restrict__ mask,
                       int rows, int n) {
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* xr = x + row * n;
  float m, s, sz;
  row_stats(xr, n, lane, m, s, sz);
  float* pr = probs + row * n;
  for (int j = lane; j < n; j += 32) {
    float p = expf(xr[j] - m) / s;
    if (mask != nullptr) p *= mask[row * n + j];
    pr[j] = p;
  }
  if (lane == 0) ent[row] = row_entropy(s, sz);
}

// ---------------------------------------------------------------------------
// The entropy of wide rows (the decode path's LM-head off-ramp)
// ---------------------------------------------------------------------------

constexpr int kEntThreads = 256;
constexpr int kEntWarps = kEntThreads / 32;
constexpr int kEntMaxCluster = 8;
constexpr long kEntMinBlockElems = 4096;   // a cluster block's least share of a row
constexpr int kEntUnroll = 4;              // loads in flight per thread

// (max, sum of e^z, sum of z e^z) over a set of logits, z = x - max; the
// empty set is (-inf, 0, 0).
struct Triple {
  float m, s, sz;
};

// The triple of the union of two sets: both rescaled to the larger max.
// Symmetric in its operands (IEEE addition commutes), so the two lanes of
// a shuffle pair get the same bits.
__device__ __forceinline__ Triple merge(const Triple a, const Triple b) {
  const float m = fmaxf(a.m, b.m);
  Triple t = {m, 0.f, 0.f};
  if (a.s > 0.f) {
    const float d = a.m - m, c = expf(d);
    t.s = c * a.s;
    t.sz = c * (a.sz + d * a.s);
  }
  if (b.s > 0.f) {
    const float d = b.m - m, c = expf(d);
    t.s += c * b.s;
    t.sz += c * (b.sz + d * b.s);
  }
  return t;
}

__device__ __forceinline__ Triple shfl_merge(Triple t, int off) {
  Triple o;
  o.m = __shfl_xor_sync(0xffffffffu, t.m, off);
  o.s = __shfl_xor_sync(0xffffffffu, t.s, off);
  o.sz = __shfl_xor_sync(0xffffffffu, t.sz, off);
  return merge(t, o);
}

__device__ __forceinline__ Triple warp_merge(Triple t) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) t = shfl_merge(t, off);
  return t;
}

// Fold VEC logits into a thread's triple: rescale once to the chunk's max,
// then one exp per logit.
template <int VEC>
__device__ __forceinline__ void fold(Triple& t, const float* v) {
  float cm = v[0];
#pragma unroll
  for (int i = 1; i < VEC; ++i) cm = fmaxf(cm, v[i]);
  if (cm > t.m) {
    if (t.s > 0.f) {
      const float d = t.m - cm, c = expf(d);
      t.sz = c * (t.sz + d * t.s);
      t.s = c * t.s;
    }
    t.m = cm;
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float z = v[i] - t.m, e = expf(z);
    t.s += e;
    t.sz = fmaf(z, e, t.sz);
  }
}

// VEC logits of a row from global memory, widened to fp32: one 16-byte
// load for 4 fp32 or 8 bf16 logits, else one scalar load.
template <typename T, int VEC>
__device__ __forceinline__ void load_chunk(const T* p, float* v) {
  if constexpr (std::is_same_v<T, float> && VEC == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (std::is_same_v<T, __nv_bfloat16> && VEC == 8) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
    static_assert(VEC == 1, "16-byte vectors or scalars only");
    if constexpr (std::is_same_v<T, float>)
      v[0] = __ldg(p);
    else
      v[0] = __bfloat162float(p[0]);
  }
}

// grid (cluster, rows), clusters of (cluster, 1, 1) blocks: rank r of row
// `row` owns units [r * per, (r + 1) * per) of the row's n / VEC units.
// T is float or __nv_bfloat16 (read as it is, computed in fp32, as the JAX
// kernel casts its rows to fp32).
template <typename T, int VEC>
__global__ void __launch_bounds__(kEntThreads)
entropy_rows_kernel(float* __restrict__ ent, const T* __restrict__ x, long n) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long row = blockIdx.y;
  const T* xr = x + row * n;
  const long units = n / VEC;
  const long per = (units + cs - 1) / cs;
  const long u0 = rank * per;
  const long u1 = u0 + per < units ? u0 + per : units;

  Triple t = {-INFINITY, 0.f, 0.f};
  long u = u0 + tid;
  for (; u + (kEntUnroll - 1) * kEntThreads < u1; u += kEntUnroll * kEntThreads) {
    float v[kEntUnroll][VEC];
#pragma unroll
    for (int j = 0; j < kEntUnroll; ++j) load_chunk<T, VEC>(xr + (u + j * kEntThreads) * VEC, v[j]);
#pragma unroll
    for (int j = 0; j < kEntUnroll; ++j) fold<VEC>(t, v[j]);
  }
  for (; u < u1; u += kEntThreads) {
    float v[VEC];
    load_chunk<T, VEC>(xr + u * VEC, v);
    fold<VEC>(t, v);
  }

  // the warp, then the block's warps, then the cluster's blocks
  __shared__ Triple warp_t[kEntWarps];
  __shared__ Triple block_t;
  t = warp_merge(t);
  if (lane == 0) warp_t[warp] = t;
  __syncthreads();
  if (warp == 0) {
    const Triple empty = {-INFINITY, 0.f, 0.f};
    t = warp_merge(lane < kEntWarps ? warp_t[lane] : empty);
    if (lane == 0) block_t = t;
  }
  cluster.sync();
  if (rank == 0 && warp == 0) {
    const Triple empty = {-INFINITY, 0.f, 0.f};
    t = warp_merge(lane < cs ? *cluster.map_shared_rank(&block_t, lane) : empty);
    if (lane == 0) ent[row] = fmaxf(logf(t.s) - t.sz / t.s, 0.f);
  }
  // no block leaves while rank 0 may still read its triple
  cluster.sync();
}

int g_ent_sms[64];

template <typename T>
cudaError_t launch_entropy_rows(float* ent, const T* x, int rows, int n, cudaStream_t stream,
                                int device) {
  if (g_ent_sms[device] == 0) {
    const cudaError_t err =
        cudaDeviceGetAttribute(&g_ent_sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  int cs = 1;
  while (cs < kEntMaxCluster && static_cast<long>(n) / (cs * 2) >= kEntMinBlockElems &&
         static_cast<long>(rows) * cs * 2 <= 2L * g_ent_sms[device])
    cs *= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, rows, 1);
  cfg.blockDim = dim3(kEntThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  constexpr int kVec = 16 / sizeof(T);     // 4 fp32 or 8 bf16 per 16-byte load
  const bool vec = n % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const cudaError_t err =
      vec ? cudaLaunchKernelEx(&cfg, entropy_rows_kernel<T, kVec>, ent, x, static_cast<long>(n))
          : cudaLaunchKernelEx(&cfg, entropy_rows_kernel<T, 1>, ent, x, static_cast<long>(n));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The off-ramp head
// ---------------------------------------------------------------------------

constexpr int kHeadThreads = 256;
constexpr int kHeadWarps = kHeadThreads / 32;
constexpr int kNB = 8;                    // pooler columns per block
constexpr int kCPT = 4;                   // of them per thread
constexpr int kCG = kNB / kCPT;           // column groups
constexpr int kKS = kHeadThreads / kCG;   // k-slices

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// AF code [s | e (n_exp) | m (n_mant)] -> (-1)^s 2^(e + e_min) (1 + m / 2^n_mant),
// e = m = 0 -> signed zero; built from bits, exact.
__device__ __forceinline__ float af_decode(uint32_t code, int e_min, int n_bits, int n_exp) {
  const int n_mant = n_bits - 1 - n_exp;
  const uint32_t sign = (code >> (n_bits - 1)) & 1u;
  const uint32_t mag = code & ((1u << (n_bits - 1)) - 1u);
  if (mag == 0u) return __uint_as_float(sign << 31);
  const uint32_t e = mag >> n_mant, m = mag & ((1u << n_mant) - 1u);
  return __uint_as_float((sign << 31) | ((e + static_cast<uint32_t>(e_min + 127)) << 23) |
                         (m << (23 - n_mant)));
}

template <bool AF>
__device__ __forceinline__ float weight(const void* w, long i, int e_min, int n_bits, int n_exp) {
  if constexpr (AF) {
    return af_decode(static_cast<const uint8_t*>(w)[i], e_min, n_bits, n_exp);
  } else {
    return static_cast<const float*>(w)[i];
  }
}

struct HeadArgs {
  float* out;                 // [B, C + 2]
  float* partial;             // [gridDim.x, B, C] scratch
  unsigned* counter;          // 0 between launches; one launch at a time
  const float* h;             // CLS row b at h + b * row_stride, D contiguous floats
  long row_stride;
  int B, D, C;
  const void* pooler_w;       // [D, D] fp32 or codes
  const float* pooler_b;      // [D]
  const void* cls_w;          // [D, C] fp32 or codes
  const float* cls_b;         // [C]
  const uint8_t* active;      // [B] bool, or null (all active)
  float threshold;
  int pooler_e_min, cls_e_min, n_bits, n_exp;
  int h_vec, w_vec;           // 16-byte rows of h; vector rows of the weight slice
  long smem_floats;           // the block's shared memory, in floats
};

// Shared memory, in floats: weight slice [D][kNB], CLS rows [RB][D],
// per-warp column sums [kHeadWarps][RB][kNB], pooled [RB][kNB], the
// classifier slice [kNB][C]; then raw codes [D][kNB] bytes (AF only).
long head_smem_floats(int RB, int D, int C) {
  return static_cast<long>(D) * kNB + static_cast<long>(RB) * D + kHeadWarps * RB * kNB +
         RB * kNB + static_cast<long>(kNB) * C;
}

// RB: CLS rows per chunk (8 or 16; the launcher takes 8 for B <= 8).
template <bool AF, int RB>
__global__ void __launch_bounds__(kHeadThreads)
offramp_head_kernel(const HeadArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int D = a.D, C = a.C, B = a.B;
  float* ws = smem;                              // [D][kNB]
  float* xs = ws + static_cast<long>(D) * kNB;   // [RB][D]
  float* red = xs + static_cast<long>(RB) * D;   // [kHeadWarps][RB][kNB]
  float* pooled = red + kHeadWarps * RB * kNB;   // [RB][kNB]
  float* wc = pooled + RB * kNB;                 // [kNB][C]
  uint8_t* codes = reinterpret_cast<uint8_t*>(wc + static_cast<long>(kNB) * C);   // [D][kNB]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kNB;
  const int ncols = D - n0 < kNB ? D - n0 : kNB;

  // the pooler slice: rows of kNB columns
  if constexpr (AF) {
    const uint8_t* w = static_cast<const uint8_t*>(a.pooler_w);
    if (a.w_vec) {         // D % kNB == 0: every slice is kNB columns wide
      for (int k = tid; k < D; k += kHeadThreads)
        cp_async8(codes + k * kNB, w + static_cast<long>(k) * D + n0, 8);
    } else {
      for (int e = tid; e < D * kNB; e += kHeadThreads) {
        const int k = e / kNB, n = e % kNB;
        codes[e] = n < ncols ? w[static_cast<long>(k) * D + n0 + n] : 0;
      }
    }
  } else {
    const float* w = static_cast<const float*>(a.pooler_w);
    if (a.w_vec) {         // D % kNB == 0: every slice is kNB columns wide
      for (int e = tid; e < D * 2; e += kHeadThreads) {
        const int k = e >> 1, half = (e & 1) * 4;
        cp_async16(ws + k * kNB + half, w + static_cast<long>(k) * D + n0 + half, 16);
      }
    } else {
      for (int e = tid; e < D * kNB; e += kHeadThreads) {
        const int k = e / kNB, n = e % kNB;
        ws[e] = n < ncols ? w[static_cast<long>(k) * D + n0 + n] : 0.f;
      }
    }
  }
  // the classifier slice: rows n0 .. n0 + ncols of cls_w
  for (int e = tid; e < kNB * C; e += kHeadThreads) {
    const int n = e / C, c = e % C;
    wc[e] = n < ncols ? weight<AF>(a.cls_w, static_cast<long>(n0 + n) * C + c, a.cls_e_min,
                                   a.n_bits, a.n_exp)
                      : 0.f;
  }

  // thread: columns cg * kCPT .. + kCPT of the slice, k = ks, ks + kKS, ...
  const int cg = tid % kCG, ks = tid / kCG;
  for (int r0 = 0; r0 < B; r0 += RB) {
    const int rows = B - r0 < RB ? B - r0 : RB;
    // CLS rows r0 .. r0 + rows (zeros past B)
    if (a.h_vec) {
      const int q = D / 4;
      for (int e = tid; e < RB * q; e += kHeadThreads) {
        const int b = e / q, c4 = (e % q) * 4;
        const bool ok = b < rows;
        cp_async16(xs + b * D + c4, a.h + (ok ? (r0 + b) * a.row_stride + c4 : 0), ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < RB * D; e += kHeadThreads) {
        const int b = e / D, k = e % D;
        xs[e] = b < rows ? a.h[(r0 + b) * a.row_stride + k] : 0.f;
      }
    }
    cp_async_wait_all();
    __syncthreads();
    if constexpr (AF) {
      if (r0 == 0) {
        for (int e = tid; e < D * kNB; e += kHeadThreads)
          ws[e] = af_decode(codes[e], a.pooler_e_min, a.n_bits, a.n_exp);
        __syncthreads();
      }
    }

    float acc[RB][kCPT];
#pragma unroll
    for (int b = 0; b < RB; ++b)
#pragma unroll
      for (int c = 0; c < kCPT; ++c) acc[b][c] = 0.f;
    for (int k = ks; k < D; k += kKS) {
      const float4 w = *reinterpret_cast<const float4*>(ws + k * kNB + cg * kCPT);
#pragma unroll
      for (int b = 0; b < RB; ++b) {
        const float x = xs[b * D + k];
        acc[b][0] = fmaf(x, w.x, acc[b][0]);
        acc[b][1] = fmaf(x, w.y, acc[b][1]);
        acc[b][2] = fmaf(x, w.z, acc[b][2]);
        acc[b][3] = fmaf(x, w.w, acc[b][3]);
      }
    }
    // the warp's k-slices (lanes kCG apart), then the warps in order
#pragma unroll
    for (int off = kCG; off < 32; off <<= 1)
#pragma unroll
      for (int b = 0; b < RB; ++b)
#pragma unroll
        for (int c = 0; c < kCPT; ++c) acc[b][c] += __shfl_xor_sync(0xffffffffu, acc[b][c], off);
    if (lane < kCG) {
#pragma unroll
      for (int b = 0; b < RB; ++b)
#pragma unroll
        for (int c = 0; c < kCPT; ++c) red[(warp * RB + b) * kNB + lane * kCPT + c] = acc[b][c];
    }
    __syncthreads();
    if (tid < RB * kNB) {
      const int b = tid / kNB, col = tid % kNB;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kHeadWarps; ++w) s += red[(w * RB + b) * kNB + col];
      pooled[tid] = col < ncols ? tanhf(s + a.pooler_b[n0 + col]) : 0.f;
    }
    __syncthreads();
    // this block's share of the classifier: columns n0 .. n0 + kNB
    for (int e = tid; e < rows * C; e += kHeadThreads) {
      const int b = e / C, c = e % C;
      float s = 0.f;
#pragma unroll
      for (int col = 0; col < kNB; ++col) s = fmaf(pooled[b * kNB + col], wc[col * C + c], s);
      a.partial[(static_cast<long>(blockIdx.x) * B + r0 + b) * C + c] = s;
    }
    __syncthreads();      // xs, red and pooled are reused by the next chunk
  }

  // the last block to finish reduces every block's partials
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // rows in passes whose partials fit in shared memory (the launcher checks
  // that one row does); each pass loads them all at once, then sums each
  // logit over the blocks in index order
  const int G = gridDim.x, BC = B * C;
  const int per = static_cast<int>(a.smem_floats / (static_cast<long>(G + 1) * C)) < B
                      ? static_cast<int>(a.smem_floats / (static_cast<long>(G + 1) * C))
                      : B;
  for (int b0 = 0; b0 < B; b0 += per) {
    const int nb = B - b0 < per ? B - b0 : per, P = nb * C;
    float* ps = smem;                  // [G][P]
    float* lg = ps + static_cast<long>(G) * P;   // [P]
    for (int e = tid; e < G * P; e += kHeadThreads)
      ps[e] = __ldcg(a.partial + static_cast<long>(e / P) * BC + b0 * C + e % P);
    __syncthreads();
    for (int p = warp; p < P; p += kHeadWarps) {
      float s = 0.f;
      for (int i = lane; i < G; i += 32) s += ps[i * P + p];
      s = warp_sum(s);
      if (lane == 0) lg[p] = s + a.cls_b[p % C];
    }
    __syncthreads();
    for (int b = warp; b < nb; b += kHeadWarps) {
      float m, s, sz;
      row_stats(lg + b * C, C, lane, m, s, sz);
      float* o = a.out + static_cast<long>(b0 + b) * (C + 2);
      for (int c = lane; c < C; c += 32) o[c] = lg[b * C + c];
      if (lane == 0) {
        const float ent = row_entropy(s, sz);
        const bool act = a.active == nullptr || a.active[b0 + b] != 0;
        o[C] = ent;
        o[C + 1] = (act && ent < a.threshold) ? 1.f : 0.f;
      }
    }
    __syncthreads();
  }
  if (tid == 0) *a.counter = 0u;
}

// dynamic shared memory each instance may use on each device, as opted in
long g_opted_in[64][2][2];

template <bool AF, int RB>
cudaError_t launch_head(HeadArgs a, cudaStream_t stream, int device) {
  a.smem_floats = head_smem_floats(RB, a.D, a.C);
  const long bytes = a.smem_floats * 4 + (AF ? static_cast<long>(a.D) * kNB : 0);
  const int grid = (a.D + kNB - 1) / kNB;
  // the last block's reduction needs one row's partials in shared memory
  if (static_cast<long>(grid + 1) * a.C > a.smem_floats) return cudaErrorInvalidValue;
  if (bytes > g_opted_in[device][AF][RB == 16]) {
    // above 48 KB only after an opt-in (the card refuses more than it has)
    const cudaError_t err = cudaFuncSetAttribute(
        offramp_head_kernel<AF, RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    g_opted_in[device][AF][RB == 16] = bytes;
  }
  offramp_head_kernel<AF, RB><<<grid, kHeadThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <bool AF>
cudaError_t launch_head_rows(const HeadArgs& a, cudaStream_t stream, int device) {
  return a.B <= 8 ? launch_head<AF, 8>(a, stream, device) : launch_head<AF, 16>(a, stream, device);
}

bool aligned(const void* p, int n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

}  // namespace

REPRO_EXPORT int repro_softmax_entropy(float* probs, float* ent, const float* x,
                                       const float* mask, int rows, int n,
                                       void* stream, int device) {
  const DeviceScope scope(device);
  cudaError_t err = scope.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0) return 0;
  const dim3 grid((rows + kWarps - 1) / kWarps);
  softmax_entropy_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      probs, ent, x, mask, rows, n);
  return static_cast<int>(cudaGetLastError());
}

// ent [rows] fp32 <- the entropy of softmax over each row of x [rows, n]
// (fp32 when bf16 == 0, else bf16, widened to fp32 as it is read), clamped
// at 0.
REPRO_EXPORT int repro_entropy_rows(float* ent, const void* x, int rows, int n, int bf16,
                                    void* stream, int device) {
  const DeviceScope scope(device);
  cudaError_t err = scope.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= 64 || rows < 0 || rows > 65535 || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? launch_entropy_rows(ent, static_cast<const __nv_bfloat16*>(x), rows, n, st, device)
           : launch_entropy_rows(ent, static_cast<const float*>(x), rows, n, st, device));
}

// Blocks of one head launch (the rows of its partial scratch).
REPRO_EXPORT int repro_offramp_head_blocks(int D) { return (D + kNB - 1) / kNB; }

// out [B, C + 2] fp32; partial [repro_offramp_head_blocks(D), B, C] fp32
// scratch; counter: one unsigned, 0 between launches; h: CLS row b at
// h + b * row_stride (D contiguous floats); pooler_w [D, D], cls_w [D, C]:
// fp32 when af == 0, else uint8 AF(n_bits, n_exp) codes with biases
// pooler_e_min / cls_e_min; active [B] bool or null.
REPRO_EXPORT int repro_offramp_head(float* out, float* partial, unsigned* counter, const float* h,
                                    long long row_stride, int B, int D, int C,
                                    const void* pooler_w, const float* pooler_b,
                                    const void* cls_w, const float* cls_b,
                                    const uint8_t* active, float threshold, int af,
                                    int pooler_e_min, int cls_e_min, int n_bits, int n_exp,
                                    void* stream, int device) {
  const DeviceScope scope(device);
  cudaError_t err = scope.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= 64 || D <= 0 || C <= 0 || B < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  HeadArgs a;
  a.out = out;
  a.partial = partial;
  a.counter = counter;
  a.h = h;
  a.row_stride = static_cast<long>(row_stride);
  a.B = B;
  a.D = D;
  a.C = C;
  a.pooler_w = pooler_w;
  a.pooler_b = pooler_b;
  a.cls_w = cls_w;
  a.cls_b = cls_b;
  a.active = active;
  a.threshold = threshold;
  a.pooler_e_min = pooler_e_min;
  a.cls_e_min = cls_e_min;
  a.n_bits = n_bits;
  a.n_exp = n_exp;
  a.h_vec = D % 4 == 0 && row_stride % 4 == 0 && aligned(h, 16);
  a.w_vec = D % kNB == 0 && aligned(pooler_w, af ? 8 : 16);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(af ? launch_head_rows<true>(a, s, device)
                             : launch_head_rows<false>(a, s, device));
}

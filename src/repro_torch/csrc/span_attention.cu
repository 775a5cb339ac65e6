// Span-windowed attention over [BH, S, dh] rows (paper §III-B + §V-D1).
//
// Replaces the Pallas kernel repro/kernels/span_attention.py:32
// _span_attn_kernel (pallas_call at :176).  Same semantics: q is scaled by
// 1/sqrt(dh) before the dot; key j is visible to query i when
// 0 <= i-j < span (causal) or |i-j| < span (bidirectional), and j < kv_len;
// fp32 online softmax; a row with no visible key writes zeros.
//
// Design: one 256-thread block per (row bh, 64-query tile).  The block reads
// its own span and kv_len (there is no scalar prefetch on a GPU) and loops
// only over the 64-key tiles that meet [q_start - (window-1),
// q_end + (window-1)] (q_end alone when causal), so keys outside the static
// window are never read.  Each warp owns 8 query rows; per kv tile a lane
// scores 2 keys (K rows padded by one float in shared memory, so the lanes
// hit distinct banks), the warp folds them into the row's running max and
// sum, and each lane accumulates the output dims lane, lane+32, ...
//
// Bound on the H100 at the main path's shape (BH = 192, S = 128, dh = 64,
// window 64): operations, ~0.6 GFLOP of fp32 FMA for the visible (q, k)
// pairs (~9 us at 67 TFLOP/s) against ~25 MB of q, k, v and out (~7.5 us).
// The scalar FMAs and per-key shuffles stand where a later PR would put
// tensor-core tiles.
#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = BQ / kWarps;
constexpr float kNegInf = -1e30f;

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * DH + BKV * (DH + 1) + BKV * DH);
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
span_attention_kernel(float* __restrict__ out, const float* __restrict__ q,
                      const float* __restrict__ k, const float* __restrict__ v,
                      const int* __restrict__ spans, const int* __restrict__ kv_lens,
                      int Sq, int Sk, int window, int causal, float scale) {
  constexpr int NT = (DH + 31) / 32;      // output dims per lane
  extern __shared__ float smem[];
  float* Qs = smem;                       // [BQ][DH], pre-scaled
  float* Ks = Qs + BQ * DH;               // [BKV][DH + 1]
  float* Vs = Ks + BKV * (DH + 1);        // [BKV][DH]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int span = spans[bh];
  const int kvl = kv_lens != nullptr ? kv_lens[bh] : Sk;
  const float* qb = q + static_cast<long>(bh) * Sq * DH;
  const float* kb = k + static_cast<long>(bh) * Sk * DH;
  const float* vb = v + static_cast<long>(bh) * Sk * DH;

  for (int e = threadIdx.x; e < BQ * DH; e += kThreads) {
    const int gq = q0 + e / DH;
    Qs[e] = gq < Sq ? qb[static_cast<long>(gq) * DH + e % DH] * scale : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NT];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[rr][t] = 0.f;
  }

  const int n_kb = (Sk + BKV - 1) / BKV;
  const int lo = q0 - (window - 1);
  const int kb_lo = lo > 0 ? lo / BKV : 0;
  const int q_end = q0 + BQ - 1;
  const int hi = causal ? q_end : q_end + (window - 1);
  const int kb_hi = min(hi / BKV, n_kb - 1);

  for (int tile = kb_lo; tile <= kb_hi; ++tile) {
    const int k0 = tile * BKV;
    __syncthreads();                      // previous tile consumed, Qs written
    for (int e = threadIdx.x; e < BKV * DH; e += kThreads) {
      const int r = e / DH, c = e % DH;
      const bool in = k0 + r < Sk;
      const long g = static_cast<long>(k0 + r) * DH + c;
      Ks[r * (DH + 1) + c] = in ? kb[g] : 0.f;
      Vs[e] = in ? vb[g] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int row = warp + rr * kWarps;
      const int qpos = q0 + row;
      const float* qr = Qs + row * DH;
      float sc[2];
      bool ok[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kj = lane + 32 * h;
        const int kpos = k0 + kj;
        const float* kr = Ks + kj * (DH + 1);
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < DH; ++c) dot = fmaf(qr[c], kr[c], dot);
        const int dist = qpos - kpos;
        bool valid = causal ? (dist >= 0 && dist < span) : (abs(dist) < span);
        valid = valid && kpos < kvl && kpos < Sk && qpos < Sq;
        ok[h] = valid;
        sc[h] = valid ? dot : kNegInf;
      }
      const float m_new = fmaxf(m[rr], warp_max(fmaxf(sc[0], sc[1])));
      const float corr = expf(m[rr] - m_new);
      const float p0 = ok[0] ? expf(sc[0] - m_new) : 0.f;
      const float p1 = ok[1] ? expf(sc[1] - m_new) : 0.f;
      l[rr] = l[rr] * corr + warp_sum(p0 + p1);
      float a[NT];
#pragma unroll
      for (int t = 0; t < NT; ++t) a[t] = acc[rr][t] * corr;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float pa = __shfl_sync(0xffffffffu, p0, j);
        const float pb = __shfl_sync(0xffffffffu, p1, j);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int c = lane + 32 * t;
          if (c < DH) {
            a[t] = fmaf(pa, Vs[j * DH + c], a[t]);
            a[t] = fmaf(pb, Vs[(j + 32) * DH + c], a[t]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) acc[rr][t] = a[t];
      m[rr] = m_new;
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int qpos = q0 + warp + rr * kWarps;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(l[rr], 1e-20f);
    float* orow = out + (static_cast<long>(bh) * Sq + qpos) * DH;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int c = lane + 32 * t;
      if (c < DH) orow[c] = l[rr] > 0.f ? acc[rr][t] / denom : 0.f;
    }
  }
}

template <int DH>
int launch(float* out, const float* q, const float* k, const float* v, const int* spans,
           const int* kv_lens, int BH, int Sq, int Sk, int window, int causal,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        span_attention_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(BH, (Sq + BQ - 1) / BQ);
  span_attention_kernel<DH><<<grid, kThreads, smem, stream>>>(
      out, q, k, v, spans, kv_lens, Sq, Sk, window, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dh must be one of 16, 32, 64, 128; kv_lens may be null (all Sk keys valid).
REPRO_EXPORT int repro_span_attention(float* out, const float* q, const float* k,
                                      const float* v, const int* spans,
                                      const int* kv_lens, int BH, int Sq, int Sk,
                                      int dh, int window, int causal, float scale,
                                      void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (BH == 0 || Sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch<16>(out, q, k, v, spans, kv_lens, BH, Sq, Sk, window, causal, scale, s);
    case 32: return launch<32>(out, q, k, v, spans, kv_lens, BH, Sq, Sk, window, causal, scale, s);
    case 64: return launch<64>(out, q, k, v, spans, kv_lens, BH, Sq, Sk, window, causal, scale, s);
    case 128: return launch<128>(out, q, k, v, spans, kv_lens, BH, Sq, Sk, window, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

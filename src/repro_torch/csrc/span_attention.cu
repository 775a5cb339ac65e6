// Span-windowed attention over [B, H, S, dh] rows on bf16 tensor cores with
// float32 parity (paper §III-B + §V-D1).
//
// Replaces the Pallas kernel repro/kernels/span_attention.py:32
// _span_attn_kernel (pallas_call at :176).  Same semantics: q is scaled by
// 1/sqrt(dh) in float32 before the dot; key j is visible to query i when
// 0 <= i-j < span (causal) or |i-j| < span (bidirectional), and j < kv_len,
// j < Sk, i < Sq; float32 online softmax with expf; masked probabilities are
// exactly 0; out = acc / max(l, 1e-20), and zeros where l == 0 (span-0 rows).
//
// Bound on the H100 at the deployed shape (B*H = 192, S = 128, dh = 64,
// window 64): bytes, ~25 MB of q, k, v and out (~7.5 us at 3.35 TB/s),
// against ~0.6 GFLOP of visible (q, k) pairs, which in six bf16 split passes
// take ~3.6 us at 989 TFLOP/s (~9 us in scalar float32 at 67 TFLOP/s).
//
// Why bf16 tensor cores keep float32 parity (split_mma.cuh): every float32
// is exactly x0 + x1 + x2 of three bf16 values, and a bf16 product is exact
// in float32, so the six products x_i * y_j with i + j <= 2 give a float32
// dot product to within the terms of order 2^-24 relative that float32
// rounding drops anyway.  Each k16 step's six passes, the small ones first,
// go into a fresh tensor-core accumulator that is promoted with a
// round-to-nearest add, so the tensor cores' truncating accumulation never
// compounds.
//
// Design (flash-attention forward on mma.sync m16n8k16):
//   * one 128-thread block per (row b*H + h, 64-query tile); each of the 4
//     warps owns 16 query rows.  q is read once, scaled in float32, split
//     three ways and kept as three bf16 planes in shared memory, from which
//     each k16 step's A fragments come by ldmatrix.x4 (three per step).
//     Held in registers instead, the fragments took 48 more registers at
//     dh = 64 and the kernel spilled;
//   * the block reads its own span and kv_len and visits only the 32-key
//     tiles that meet its rows' window and lie below kv_len (right-padded
//     serving lanes skip their padding); a warp skips a tile that none of
//     its 16 rows can see (the skipped update is exactly the identity);
//   * each tile's K and V arrive by 16-byte cp.async (zero fill past kv_len)
//     into a float32 staging buffer, are split once into three bf16 planes
//     each, row-major with 8 bf16 of padding (conflict-free 32-bit B-fragment
//     loads of K, ldmatrix.trans of V); the next tile's copy runs while the
//     warps compute on the planes, so staging and planes are the two stages
//     of the ring.  32-key tiles (not 64) keep the score fragments at 16
//     registers and the shared memory at 70 KB (dh = 64);
//   * at dh = 64 the block may take up to 255 registers (two blocks per SM):
//     capped at 168 for three blocks per SM, the compiler spills;
//   * S = Q K^T: per n8 key tile and k16 step, six split products;
//     masking from the C-fragment coordinates (rows g, g+8; keys 2t, 2t+1);
//     row max and sum across the quad with shfl_xor 1 and 2;
//   * P V without shared memory: the C fragments of two adjacent n8 key
//     tiles are the A fragment of one k16 step; P in [0, 1] is split three
//     ways in registers and multiplied with V's planes (B fragments by
//     ldmatrix.x4.trans, two n8 dim tiles per load).  The output stays in
//     float32 registers (16 x dh per warp);
//   * operands by pointer and (batch, head, sequence) element strides, the
//     dh axis contiguous and every row 16-byte aligned: the callers pass
//     permuted [B, S, H, dh] views and the kernel writes straight into the
//     caller's output layout.  Spans and kv_lens are read by (batch, head)
//     strides too (a null spans pointer means span = window, a null kv_lens
//     means Sk).  No atomics: the same bits on every launch.
#include "split_mma.cuh"

namespace {

using namespace split_mma;

constexpr int BQ = 64;            // query rows per block
constexpr int BKV = 32;           // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

template <int DH>
struct Tile {
  static constexpr int LD = DH + 8;                   // plane row stride (bf16)
  static constexpr int RAW = BKV * DH;                // floats per staged tile (K or V)
  static constexpr int PLANE = BKV * LD;              // bf16 per plane
  static constexpr int RAW_BYTES = 2 * RAW * 4;       // staged K and V
  static constexpr int QPLANE = BQ * LD;               // bf16 per plane of Q
  static constexpr int QOFF = RAW_BYTES + 2 * 3 * PLANE * 2;  // + three planes of K and of V
  static constexpr int SMEM = QOFF + 3 * QPLANE * 2;          // + three planes of Q
  static_assert(RAW_BYTES % 16 == 0 && (PLANE * 2) % 16 == 0 && (LD * 2) % 16 == 0,
                "cp.async and ldmatrix need 16-byte alignment");
  static_assert((BKV * DH / 4) % kThreads == 0, "whole 16-byte chunks per thread");
};

struct Args {
  float* out;
  const float* q;
  const float* k;
  const float* v;
  const int* spans;               // null: every span is `window`
  const int* kv_lens;             // null: every row sees Sk keys
  long long qs[3], ks[3], vs[3], os[3];   // (batch, head, sequence) strides, elements
  long long sps[2], kvs[2];       // (batch, head) strides of spans and kv_lens
  int H, Sq, Sk, window, causal;
  float scale;
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The six split products of one k16 step into a fresh accumulator, the
// small ones (i + j = 2) first: tc = sum over i + j <= 2 of a_i * b_j.
__device__ __forceinline__ void six(float (&tc)[4], const uint32_t (&a0)[4], const uint32_t (&a1)[4],
                                    const uint32_t (&a2)[4], const uint32_t (&b0)[2],
                                    const uint32_t (&b1)[2], const uint32_t (&b2)[2]) {
  mma_zero(tc, a2, b0);
  mma(tc, a1, b1);
  mma(tc, a0, b2);
  mma(tc, a1, b0);
  mma(tc, a0, b1);
  mma(tc, a0, b0);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, DH <= 32 ? 3 : 2)
span_attention_kernel(const Args a) {
  using T = Tile<DH>;
  constexpr int KS = DH / 16;     // k16 steps over dh (Q K^T)
  constexpr int NT = DH / 8;      // n8 tiles over dh (P V)
  constexpr int JT = BKV / 8;     // n8 key tiles per tile
  extern __shared__ __align__(16) unsigned char smem[];
  float* raw = reinterpret_cast<float*>(smem);                                   // [K | V][BKV][DH]
  __nv_bfloat16* planes = reinterpret_cast<__nv_bfloat16*>(smem + T::RAW_BYTES);  // [K0 K1 K2 V0 V1 V2][BKV][LD]
  __nv_bfloat16* qplanes = reinterpret_cast<__nv_bfloat16*>(smem + T::QOFF);      // [Q0 Q1 Q2][BQ][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H;
  const int q0 = blockIdx.y * BQ;
  const int span = a.spans != nullptr ? min(a.spans[b * a.sps[0] + h * a.sps[1]], a.window) : a.window;
  const int kvl = a.kv_lens != nullptr ? min(a.kv_lens[b * a.kvs[0] + h * a.kvs[1]], a.Sk) : a.Sk;
  const float* qb = a.q + b * a.qs[0] + h * a.qs[1];
  const float* kb = a.k + b * a.ks[0] + h * a.ks[1];
  const float* vb = a.v + b * a.vs[0] + h * a.vs[1];
  float* ob = a.out + b * a.os[0] + h * a.os[1];

  // key tiles any row of the block can see
  int kt_lo = 0, kt_hi = -1;
  if (span > 0 && kvl > 0) {
    const int q_last = min(q0 + BQ, a.Sq) - 1;
    const int lo = max(q0 - (span - 1), 0);
    const int hi = min(a.causal ? q_last : q_last + span - 1, kvl - 1);
    kt_lo = lo / BKV;
    kt_hi = hi / BKV;
  }
  // ... and the keys this warp's rows can see
  const int w_first = q0 + 16 * warp, w_last = min(w_first + 15, a.Sq - 1);
  const int wk_lo = w_first - (span - 1);
  const int wk_hi = min(a.causal ? w_last : w_last + span - 1, kvl - 1);

  // Q: scaled in float32 and split into three bf16 planes, this warp's 16
  // rows (lane (g, t): rows g and g+8, columns 2t, 2t+1 and 2t+8, 2t+9 of
  // each k16 step); only this warp reads them back
  const int r0 = w_first + g, r1 = r0 + 8;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = (i & 1) ? r1 : r0;
      const int col = 16 * ks + 2 * t + ((i & 2) ? 8 : 0);
      float2 x = make_float2(0.f, 0.f);
      if (row < a.Sq) x = *reinterpret_cast<const float2*>(qb + row * a.qs[2] + col);
      uint32_t w[3];
      split3(__fmul_rn(x.x, a.scale), __fmul_rn(x.y, a.scale), w[0], w[1], w[2]);
#pragma unroll
      for (int p = 0; p < 3; ++p)
        *reinterpret_cast<uint32_t*>(qplanes + p * T::QPLANE + (row - q0) * T::LD + col) = w[p];
    }
  }
  // lane 8 * mi + ri addresses row ri of 8 x 8 matrix mi: rows +8 * (mi & 1),
  // columns +8 * (mi >> 1) (the A fragment's order; V's B fragments take
  // the same lanes as keys +8 * (mi & 1), dims +8 * (mi >> 1))
  const int mi = lane >> 3, ri = lane & 7;
  const __nv_bfloat16* qr = qplanes + (16 * warp + 8 * (mi & 1) + ri) * T::LD + 8 * (mi >> 1);

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[n][r] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  auto load_tile = [&](int kt) {
    const int k0 = kt * BKV;
#pragma unroll
    for (int i = 0; i < (BKV * DH / 4) / kThreads; ++i) {
      const int c = tid + i * kThreads, key = c / (DH / 4), col = (c % (DH / 4)) * 4;
      const bool ok = k0 + key < kvl;
      const long long row = ok ? k0 + key : 0;
      cp_async16(raw + key * DH + col, kb + row * a.ks[2] + col, ok ? 16 : 0);
      cp_async16(raw + T::RAW + key * DH + col, vb + row * a.vs[2] + col, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  if (kt_lo <= kt_hi) load_tile(kt_lo);
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    cp_async_wait<0>();
    __syncthreads();              // tile kt staged; every warp is done with the planes
    // split the staged K and V into three bf16 planes each, pairs along dh
#pragma unroll
    for (int i = 0; i < (2 * BKV * DH / 4) / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int kv = c / (BKV * DH / 4), e = c % (BKV * DH / 4);
      const int key = e / (DH / 4), col = (e % (DH / 4)) * 4;
      const float4 x = *reinterpret_cast<const float4*>(raw + kv * T::RAW + key * DH + col);
      uint32_t lo[3], hi[3];
      split3(x.x, x.y, lo[0], lo[1], lo[2]);
      split3(x.z, x.w, hi[0], hi[1], hi[2]);
#pragma unroll
      for (int p = 0; p < 3; ++p)
        *reinterpret_cast<uint2*>(planes + (3 * kv + p) * T::PLANE + key * T::LD + col) =
            make_uint2(lo[p], hi[p]);
    }
    __syncthreads();              // planes ready; the staging buffer is free
    if (kt < kt_hi) load_tile(kt + 1);

    const int k0 = kt * BKV;
    if (w_first >= a.Sq || k0 > wk_hi || k0 + BKV - 1 < wk_lo) continue;

    // S = Q K^T for this warp's 16 rows and the tile's 32 keys
    float s[JT][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[3][4];
#pragma unroll
      for (int p = 0; p < 3; ++p) ldmatrix_x4(qa[p], qr + p * T::QPLANE + 16 * ks);
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        const __nv_bfloat16* kr = planes + (8 * j + g) * T::LD + 2 * t + 16 * ks;
        uint32_t kf[3][2];
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          kf[p][0] = ld32(kr + p * T::PLANE);
          kf[p][1] = ld32(kr + p * T::PLANE + 8);
        }
        float tc[4];
        six(tc, qa[0], qa[1], qa[2], kf[0], kf[1], kf[2]);
        if (ks == 0) {
#pragma unroll
          for (int r = 0; r < 4; ++r) s[j][r] = tc[r];
        } else {
          promote(s[j], tc);
        }
      }
    }

    // mask from the C-fragment coordinates, then the online softmax
    uint32_t ok = 0;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = (r & 2) ? r1 : r0;
        const int key = k0 + 8 * j + 2 * t + (r & 1);
        const int d = row - key;
        const bool vis = (a.causal ? (d >= 0 && d < span) : (abs(d) < span)) && key < kvl && row < a.Sq;
        ok |= static_cast<uint32_t>(vis) << (4 * j + r);
        s[j][r] = vis ? s[j][r] : kNegInf;
        mx[r >> 1] = fmaxf(mx[r >> 1], s[j][r]);
      }
    float m_new[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_new[i] = fmaxf(m[i], quad_max(mx[i]));
      corr[i] = expf(m[i] - m_new[i]);
      m[i] = m_new[i];
    }
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        s[j][r] = (ok >> (4 * j + r)) & 1u ? expf(s[j][r] - m_new[r >> 1]) : 0.f;
        sum[r >> 1] += s[j][r];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + quad_sum(sum[i]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P V: the C fragments of n8 key tiles 2kk and 2kk+1 are the A
    // fragment of k16 step kk; V's B fragments come by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t pa[3][4];
      split3(s[2 * kk][0], s[2 * kk][1], pa[0][0], pa[1][0], pa[2][0]);
      split3(s[2 * kk][2], s[2 * kk][3], pa[0][1], pa[1][1], pa[2][1]);
      split3(s[2 * kk + 1][0], s[2 * kk + 1][1], pa[0][2], pa[1][2], pa[2][2]);
      split3(s[2 * kk + 1][2], s[2 * kk + 1][3], pa[0][3], pa[1][3], pa[2][3]);
      const __nv_bfloat16* vr =
          planes + 3 * T::PLANE + (16 * kk + 8 * (mi & 1) + ri) * T::LD + 8 * (mi >> 1);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t vf[3][2][2];     // [plane][dim tile n, n+1][b0, b1]
#pragma unroll
        for (int p = 0; p < 3; ++p)
          ldmatrix_x4_trans(vf[p][0][0], vf[p][0][1], vf[p][1][0], vf[p][1][1], vr + p * T::PLANE + 8 * n);
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          float tc[4];
          six(tc, pa[0], pa[1], pa[2], vf[0][nn], vf[1][nn], vf[2][nn]);
          promote(o[n + nn], tc);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i ? r1 : r0;
    if (row >= a.Sq) continue;
    const float den = fmaxf(l[i], 1e-20f);
    float* orow = ob + row * a.os[2] + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 val = l[i] > 0.f ? make_float2(o[n][2 * i] / den, o[n][2 * i + 1] / den)
                                    : make_float2(0.f, 0.f);
      *reinterpret_cast<float2*>(orow + 8 * n) = val;
    }
  }
}

bool g_opted_in[4][64];   // per head-dim instance and device

template <int DH>
int launch(const Args& a, int BH, int device, cudaStream_t stream, bool* opted_in) {
  constexpr int smem = Tile<DH>::SMEM;
  if (smem > 48 * 1024 && !opted_in[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        span_attention_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[device] = true;
  }
  const dim3 grid(BH, (a.Sq + BQ - 1) / BQ);
  span_attention_kernel<DH><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory per block at dh = 64 (the main path's), for the
// build report.
REPRO_EXPORT int repro_smem_bytes() { return Tile<64>::SMEM; }

// q, out [B, H, Sq, dh] and k, v [B, H, Sk, dh] by pointer and (batch,
// head, sequence) element strides; the dh axis contiguous, every row
// 16-byte aligned.  spans (null: every span is `window`) and kv_lens (null:
// Sk) are int32, read at b * stride_b + h * stride_h.  dh is one of 16, 32,
// 64, 128.
REPRO_EXPORT int repro_span_attention(
    float* out, const float* q, const float* k, const float* v, const int* spans,
    const int* kv_lens, int B, int H, int Sq, int Sk, int dh, int window, int causal, float scale,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    long long sp_sb, long long sp_sh, long long kv_sb, long long kv_sh, void* stream, int device) {
  if (device < 0 || device >= 64 || B < 0 || H < 1 || Sq < 0 || Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const DeviceScope scope(device);
  const cudaError_t err = scope.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || Sq == 0) return 0;
  Args a = {out, q, k, v, spans, kv_lens,
            {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss}, {o_sb, o_sh, o_ss},
            {sp_sb, sp_sh}, {kv_sb, kv_sh}, H, Sq, Sk, window, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BH = B * H;
  switch (dh) {
    case 16: return launch<16>(a, BH, device, s, g_opted_in[0]);
    case 32: return launch<32>(a, BH, device, s, g_opted_in[1]);
    case 64: return launch<64>(a, BH, device, s, g_opted_in[2]);
    case 128: return launch<128>(a, BH, device, s, g_opted_in[3]);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

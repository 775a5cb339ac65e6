// Span attention's long full-window rows on Hopper: bidirectional attention
// over [B, H, S, 64] rows of 1024 keys and more, every key below the row's
// kv_len visible to every query, on bf16 wgmma with float32 parity.
//
// Replaces, for these calls, the same Pallas kernel as span_attention.cu:
// repro/kernels/span_attention.py:32 _span_attn_kernel (pallas_call at :176),
// with the same semantics: q is scaled by 1/sqrt(64) in float32 before the
// dot; key j is visible to every query when j < kv_len (and j < Sk); float32
// online softmax with expf; masked probabilities are exactly 0; out = acc /
// max(l, 1e-20), and zeros where l == 0 (kv_len 0).  Query rows at or past
// kv_len (a right-padded lane) are computed like any other.  The wrapper
// (kernels/span_attention.py ``long_rows``) sends a call here only when dh ==
// 64, the call is bidirectional with no per-head spans, the window covers
// every key of every query and Sq, Sk >= 1024; every other call keeps
// span_attention.cu's kernel.
//
// Bound on the H100 at [1, 8192, 16, 64], every key visible: 0.275 TFLOP
// of float32 work over the (q, k) pairs (4 * 64 * 8192^2 * 16), 1.65 TFLOP
// in six bf16 passes, ~1.67 ms at 989 TFLOP/s; bytes 134 MB of q, k, v and
// out and 96 MB of planes written once and read at least once (~0.1 ms at
// 3.35 TB/s).  The operations bound it, ~17 to 1.
//
// Numerics: those of span_attention.cu (split_mma.cuh): every float32 is the
// exact sum of three bf16 values, each k16 step sums the six products x_i *
// y_j with i + j <= 2, the small ones first, into a fresh tensor-core
// accumulator, promoted into the float32 score or output with a
// round-to-nearest add.  Only the order of the online softmax's tiles
// differs (64 keys, not 32), so the result is held to the plain float32
// version, not to the short-row kernel's bits.
//
// Design (the short-row kernel re-reads and re-splits all of K and V for
// every 64-query tile, on mma.sync with 4 warps; at 8192 keys that work and
// the mma.sync rate dominate):
//   * span_attention_kernel_split, a pre-pass: K and V are read once
//     through the caller's strides and written as three bf16 planes each, in
//     64-key tiles of [K0 K1 K2 V0^T V1^T V2^T], every plane 64 x 64 in
//     wgmma's canonical K-major layout without swizzle (8 x 8 core matrices
//     of 128 contiguous bytes: ``core``).  V is written transposed (dims as
//     rows, keys contiguous), so both products take K-major B operands and
//     no transposing descriptor.  Keys at or past kv_len are zeros, and no
//     tile past the row's kv_len tile is written or read;
//   * span_attention_kernel_long, one 384-thread block per (row b*H + h,
//     128-query tile), blocks in (row, query tile) order so that a head's
//     planes (6 MB at 8192 keys) stay in the 50 MB L2 while its query tiles
//     pass over them.  Warpgroups 0 and 1 consume, 64 query rows each;
//     warpgroup 2 produces: setmaxnreg gives the consumers 232 registers and
//     the producer 40;
//   * the producer's one thread streams each 64-key tile (48 KB, six planes)
//     by TMA bulk copies into a ring of 3 stages, completion reported to the
//     stage's full mbarrier; consumers release a stage through its empty
//     mbarrier (one arrival per consumer warp);
//   * each consumer scales its float32 query rows in float32, splits them
//     into three bf16 planes in shared memory (the canonical layout), and
//     runs S = Q K^T as wgmma m64n64k16 with both operands in shared memory:
//     per k16 step a chain of six products into a fresh accumulator, two
//     accumulators alternating so that one chain runs while the other is
//     promoted;
//   * mask (the last tile, keys past kv_len), float32 online softmax, then P
//     split three ways in registers: wgmma's accumulator layout is its
//     register A fragment layout (rows g and g+8 of each warp's 16, keys 2t,
//     2t+1 and +8), so P V is wgmma m64n64k16 with A from registers and V^T's
//     planes as the shared-memory B operand, the same six-product chains;
//   * the output stays in float32 registers and is written through the
//     caller's strides.  No atomics: the same bits on every launch.
//
// Measured on one H100 (700 W) at [1, 8192, 16, 64] / [16, 8192, 16, 64]
// with ragged kv_lens, against the short-row kernel's 7.18 / 59.2 ms:
// 2.83 / 25.0-27.5 ms, 59% of the six-pass bound at B = 1.  Departures tried
// and measured there, none kept:
//   * the softmax's probabilities as `masked ? 0 : expf(..)` compiled to a
//     branch around every expf, one after another (3.83 ms); expf of the
//     masked -1e30 is exactly 0 already, and straight-line code overlaps
//     the 32 exponentials (2.83 ms);
//   * Q held as register A fragments (S on wgmma's register-sourced form,
//     48 more registers, 4 stages): 2.92-3.00 ms with one fresh accumulator
//     for S, spills with two;
//   * the consumers taking turns at the tensor cores (named barriers, S of
//     tile t with P V of tile t - 1): 3.44-3.49 ms;
//   * the next tile's S chains issued before this tile's softmax: 2.92 ms;
//   * without the softmax at all the kernel takes 2.15 ms: the remaining
//     cost is the exponentials, the P split and the promotions.
//   * 64-key tiles: 128-key tiles need 96 KB a stage, and two stages with
//     the query planes pass the 227 KB a block may hold.
#include <cuda_bf16.h>

#include "split_mma.cuh"

namespace {

using namespace split_mma;

constexpr int DH = 64;
constexpr int BM = 128;                         // queries per block: two consumer warpgroups of 64
constexpr int BN = 64;                          // keys per tile
constexpr int NSTAGE = 3;
constexpr int PLANE_BYTES = BN * DH * 2;        // one 64 x 64 bf16 plane
constexpr int TILE_BYTES = 6 * PLANE_BYTES;     // K0 K1 K2 V0^T V1^T V2^T
constexpr int Q_BYTES = 2 * 3 * PLANE_BYTES;    // three query planes per consumer
constexpr int BAR_OFF = Q_BYTES + NSTAGE * TILE_BYTES;
constexpr int SMEM = BAR_OFF + 2 * NSTAGE * 8;
constexpr int kThreads = 384;
constexpr int kSplitThreads = 256;
constexpr float kNegInf = -1e30f;

// element offset of (row, col) in a 64 x 64 plane: core matrix (row / 8,
// col / 8) at 64 * (8 * (row / 8) + col / 8), each of 8 rows of 8 elements.
// A k16 step's two core matrices along col are 128 bytes apart (LBO), the
// next 8 rows 1024 bytes (SBO); step ks starts 256 * ks bytes in.
__host__ __device__ constexpr int core(int row, int col) {
  return (row >> 3) * 512 + (col >> 3) * 64 + (row & 7) * 8 + (col & 7);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory matrix descriptor: no swizzle, LBO 128 B, SBO 1024 B
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32);
}

// ---------------------------------------------------------------------------
// mbarrier, TMA bulk copy, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait for the phase of parity `parity` to complete.  A wait that outlasts
// any sound schedule by orders of magnitude traps (a launch error) rather
// than hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from touching registers a wgmma in flight reads or writes
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[3][4]) {
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[p][i])::"memory");
}

#define REPRO_ACC32                                                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, " \
  "%23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define REPRO_ACC32_OUT(d)                                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),  \
      "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),   \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (+)= A B, m64n64k16, A and B in shared memory (K-major); acc == 0
// starts a fresh sum.  d[4j + r] holds (row 16 w + g + 8 (r >> 1), column
// 8 j + 2 t + (r & 1)) for warp w of the warpgroup and lane (g, t).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_ACC32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : REPRO_ACC32_OUT(d)
      : "l"(da), "l"(db), "r"(acc));
}

// the same with A from registers: a[0..3] = (row g, k 2t..2t+1), (row g+8,
// k 2t..), (row g, k 2t+8..), (row g+8, k 2t+8..) of the warp's 16 rows
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_ACC32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : REPRO_ACC32_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// one k16 step of S = Q K^T: the six split products into a fresh
// accumulator, small ones first (span_attention.cu `six`)
__device__ __forceinline__ void chain_qk(float (&d)[32], uint32_t q, uint32_t k, int ks) {
  const uint32_t o = 256 * ks;
  wgmma_fence();
  wgmma_ss(d, desc(q + 2 * PLANE_BYTES + o), desc(k + o), 0);
  wgmma_ss(d, desc(q + PLANE_BYTES + o), desc(k + PLANE_BYTES + o), 1);
  wgmma_ss(d, desc(q + o), desc(k + 2 * PLANE_BYTES + o), 1);
  wgmma_ss(d, desc(q + PLANE_BYTES + o), desc(k + o), 1);
  wgmma_ss(d, desc(q + o), desc(k + PLANE_BYTES + o), 1);
  wgmma_ss(d, desc(q + o), desc(k + o), 1);
  wgmma_commit();
}

// one k16 step of O = P V: P's planes in registers, V^T's in shared memory
__device__ __forceinline__ void chain_pv(float (&d)[32], const uint32_t (&p)[3][4], uint32_t vt, int kk) {
  const uint32_t o = 256 * kk;
  wgmma_fence();
  wgmma_rs(d, p[2], desc(vt + o), 0);
  wgmma_rs(d, p[1], desc(vt + PLANE_BYTES + o), 1);
  wgmma_rs(d, p[0], desc(vt + 2 * PLANE_BYTES + o), 1);
  wgmma_rs(d, p[1], desc(vt + o), 1);
  wgmma_rs(d, p[0], desc(vt + PLANE_BYTES + o), 1);
  wgmma_rs(d, p[0], desc(vt + o), 1);
  wgmma_commit();
}

// P's k16 step kk as three planes of A fragments: keys 16 kk .. 16 kk + 15
// are accumulator columns 8 j + 2t (+1) of n8 tiles j = 2 kk, 2 kk + 1
__device__ __forceinline__ void split_p(uint32_t (&p)[3][4], const float (&s)[32], int kk) {
#pragma unroll
  for (int r = 0; r < 4; ++r) split3(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], p[0][r], p[1][r], p[2][r]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

struct Args {
  float* out;
  const float* q;
  const float* k;
  const float* v;
  const int* kv_lens;             // null: every row sees Sk keys
  unsigned char* planes;          // [B * H][n_tiles][TILE_BYTES]
  long long qs[3], ks[3], vs[3], os[3];   // (batch, head, sequence) strides, elements
  long long kvs[2];               // (batch, head) strides of kv_lens
  int H, Sq, Sk, n_tiles;
  float scale;
};

__device__ __forceinline__ int row_kv_len(const Args& a, int b, int h) {
  return a.kv_lens != nullptr ? min(a.kv_lens[b * a.kvs[0] + h * a.kvs[1]], a.Sk) : a.Sk;
}

// ---------------------------------------------------------------------------
// The pre-pass: one 256-thread block per (64-key tile, row)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kSplitThreads) span_attention_kernel_split(const Args a) {
  __shared__ float kt[BN][DH + 1], vt[BN][DH + 1];
  const int tile = blockIdx.x, bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int kvl = row_kv_len(a, b, h);
  const int k0 = tile * BN;
  if (k0 >= kvl) return;          // never read
  const float* kb = a.k + b * a.ks[0] + h * a.ks[1];
  const float* vb = a.v + b * a.vs[0] + h * a.vs[1];
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < (BN * DH / 4) / kSplitThreads; ++i) {
    const int f = tid + i * kSplitThreads, key = f / (DH / 4), col = (f % (DH / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (k0 + key < kvl) {
      x = *reinterpret_cast<const float4*>(kb + (k0 + key) * a.ks[2] + col);
      y = *reinterpret_cast<const float4*>(vb + (k0 + key) * a.vs[2] + col);
    }
    kt[key][col] = x.x;
    kt[key][col + 1] = x.y;
    kt[key][col + 2] = x.z;
    kt[key][col + 3] = x.w;
    vt[key][col] = y.x;
    vt[key][col + 1] = y.y;
    vt[key][col + 2] = y.z;
    vt[key][col + 3] = y.w;
  }
  __syncthreads();
  __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(a.planes + (static_cast<size_t>(bh) * a.n_tiles + tile) *
                                                                       TILE_BYTES);
  constexpr int PLANE = PLANE_BYTES / 2;
  // 512 rows of 8 elements per matrix: K's (key, 8 dims), V^T's (dim, 8 keys)
#pragma unroll
  for (int i = 0; i < (BN * DH / 8) / kSplitThreads; ++i) {
    const int e = tid + i * kSplitThreads, r = e % 64, c = 8 * (e / 64);
    uint32_t kw[3][4], vw[3][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      split3(kt[r][c + 2 * j], kt[r][c + 2 * j + 1], kw[0][j], kw[1][j], kw[2][j]);
      split3(vt[c + 2 * j][r], vt[c + 2 * j + 1][r], vw[0][j], vw[1][j], vw[2][j]);
    }
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      *reinterpret_cast<uint4*>(dst + p * PLANE + core(r, c)) = make_uint4(kw[p][0], kw[p][1], kw[p][2], kw[p][3]);
      *reinterpret_cast<uint4*>(dst + (3 + p) * PLANE + core(r, c)) =
          make_uint4(vw[p][0], vw[p][1], vw[p][2], vw[p][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// The main kernel
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1) span_attention_kernel_long(const Args a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + NSTAGE;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int kvl = row_kv_len(a, b, h);
  const int n_row = (kvl + BN - 1) / BN;   // tiles below kv_len
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);    // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // the producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 256) {
      const unsigned char* src = a.planes + static_cast<size_t>(bh) * a.n_tiles * TILE_BYTES;
      for (int t = 0; t < n_row; ++t) {
        const int s = t % NSTAGE;
        mbar_wait(&empty[s], ((t / NSTAGE) & 1) ^ 1);
        mbar_expect_tx(&full[s], TILE_BYTES);
        unsigned char* dst = smem + Q_BYTES + s * TILE_BYTES;
#pragma unroll
        for (int p = 0; p < 6; ++p)
          bulk_copy(dst + p * PLANE_BYTES, src + static_cast<size_t>(t) * TILE_BYTES + p * PLANE_BYTES,
                    PLANE_BYTES, &full[s]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int ct = tid & 127, warp = ct >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int row0 = blockIdx.x * BM + 64 * wg;
    unsigned char* qp = smem + wg * 3 * PLANE_BYTES;
    // Q: scaled in float32 and split into three bf16 planes
    {
      const float* qb = a.q + b * a.qs[0] + h * a.qs[1];
      __nv_bfloat16* q16 = reinterpret_cast<__nv_bfloat16*>(qp);
#pragma unroll
      for (int i = 0; i < (64 * DH / 4) / 128; ++i) {
        const int f = ct + i * 128, r = f / (DH / 4), c = (f % (DH / 4)) * 4;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row0 + r < a.Sq) x = *reinterpret_cast<const float4*>(qb + (row0 + r) * a.qs[2] + c);
        uint32_t lo[3], hi[3];
        split3(__fmul_rn(x.x, a.scale), __fmul_rn(x.y, a.scale), lo[0], lo[1], lo[2]);
        split3(__fmul_rn(x.z, a.scale), __fmul_rn(x.w, a.scale), hi[0], hi[1], hi[2]);
#pragma unroll
        for (int p = 0; p < 3; ++p)
          *reinterpret_cast<uint2*>(q16 + p * (PLANE_BYTES / 2) + core(r, c)) = make_uint2(lo[p], hi[p]);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    }
    const uint32_t q_addr = smem_u32(qp);

    float o[32], ta[32], tb[32], sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = ta[i] = tb[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    uint32_t pa[3][4], pb[3][4];

    for (int t = 0; t < n_row; ++t) {
      const int s = t % NSTAGE;
      mbar_wait(&full[s], (t / NSTAGE) & 1);
      const uint32_t k_addr = smem_u32(smem + Q_BYTES + s * TILE_BYTES);
      const uint32_t v_addr = k_addr + 3 * PLANE_BYTES;

      // S = Q K^T: four k16 chains, promoted in order
      chain_qk(ta, q_addr, k_addr, 0);
      chain_qk(tb, q_addr, k_addr, 1);
      wgmma_wait<1>();
      fence_regs(ta);
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = ta[i];
      chain_qk(ta, q_addr, k_addr, 2);
      wgmma_wait<1>();
      fence_regs(tb);
      promote(sc, tb);
      chain_qk(tb, q_addr, k_addr, 3);
      wgmma_wait<1>();
      fence_regs(ta);
      promote(sc, ta);
      wgmma_wait<0>();
      fence_regs(tb);
      promote(sc, tb);

      // mask the keys past kv_len (the last tile), then the online softmax
      const int k_end = kvl - t * BN - 2 * t4;   // this lane's columns below it are keys below kv_len
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 8 * (i >> 2) + (i & 1) < k_end ? sc[i] : kNegInf;
#pragma unroll
      for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float m_new[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_new[r] = fmaxf(m[r], quad_max(mx[r]));
        corr[r] = expf(m[r] - m_new[r]);
        m[r] = m_new[r];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sc[i] = expf(sc[i] - m_new[(i >> 1) & 1]);   // exactly 0 where masked: m_new is finite
        sum[(i >> 1) & 1] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(sum[r]);
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= corr[(i >> 1) & 1];

      // O += P V: four k16 chains, promoted in order
      split_p(pa, sc, 0);
      chain_pv(ta, pa, v_addr, 0);
      split_p(pb, sc, 1);
      chain_pv(tb, pb, v_addr, 1);
      wgmma_wait<1>();
      fence_regs(ta);
      fence_regs(pa);
      promote(o, ta);
      split_p(pa, sc, 2);
      chain_pv(ta, pa, v_addr, 2);
      wgmma_wait<1>();
      fence_regs(tb);
      fence_regs(pb);
      promote(o, tb);
      split_p(pb, sc, 3);
      chain_pv(tb, pb, v_addr, 3);
      wgmma_wait<1>();
      fence_regs(ta);
      fence_regs(pa);
      promote(o, ta);
      wgmma_wait<0>();
      fence_regs(tb);
      fence_regs(pb);
      promote(o, tb);
      if (lane == 0) mbar_arrive(&empty[s]);   // this warp is done with the stage
    }

    float* ob = a.out + b * a.os[0] + h * a.os[1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 16 * warp + g + 8 * r;
      if (row >= a.Sq) continue;
      const float den = fmaxf(l[r], 1e-20f);
      float* orow = ob + row * a.os[2] + 2 * t4;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 val = l[r] > 0.f ? make_float2(o[4 * j + 2 * r] / den, o[4 * j + 2 * r + 1] / den)
                                      : make_float2(0.f, 0.f);
        *reinterpret_cast<float2*>(orow + 8 * j) = val;
      }
    }
  }
}

bool g_opted_in[64];   // per device

}  // namespace

// Dynamic shared memory of the main kernel, for the build report.
REPRO_EXPORT int repro_smem_bytes() { return SMEM; }

// q, out [B, H, Sq, 64] and k, v [B, H, Sk, 64] by pointer and (batch,
// head, sequence) element strides, the dh axis contiguous and every row
// 16-byte aligned; kv_lens (null: Sk) int32, read at b * stride_b + h *
// stride_h; planes a 16-byte aligned scratch of B * H * ceil(Sk / 64) *
// TILE_BYTES bytes (kernels/span_attention.py LONG_TILE_BYTES).  Launches the pre-pass and the main
// kernel on `stream`.
REPRO_EXPORT int repro_span_attention_long(
    float* out, const float* q, const float* k, const float* v, const int* kv_lens, void* planes, int B, int H,
    int Sq, int Sk, float scale, long long q_sb, long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    long long kv_sb, long long kv_sh, void* stream, int device) {
  if (device < 0 || device >= 64 || B < 0 || H < 1 || Sq < 0 || Sk < 0 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const DeviceScope scope(device);
  const cudaError_t err = scope.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || Sq == 0) return 0;
  const int n_tiles = (Sk + BN - 1) / BN;
  Args a = {out, q, k, v, kv_lens, static_cast<unsigned char*>(planes),
            {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss}, {o_sb, o_sh, o_ss},
            {kv_sb, kv_sh}, H, Sq, Sk, n_tiles, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!g_opted_in[device]) {
    const cudaError_t e =
        cudaFuncSetAttribute(span_attention_kernel_long, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    g_opted_in[device] = true;
  }
  if (n_tiles > 0) {
    span_attention_kernel_split<<<dim3(n_tiles, B * H), kSplitThreads, 0, s>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  span_attention_kernel_long<<<dim3((Sq + BM - 1) / BM, B * H), kThreads, SMEM, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

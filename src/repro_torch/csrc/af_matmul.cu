// AF8-weight matmul: out[M, N] = x[M, K] @ decode(codes[K, N], e_min), fp32
// in and out, on bf16 tensor cores with float32 parity.
//
// Replaces the Pallas kernel repro/kernels/adaptivfloat_k.py:99
// _af_matmul_kernel (pallas_call at :141, per-tile decode _decode_tile at
// :87).  The weights stay uint8 AdaptivFloat codes in device memory, one byte
// per weight read:
//   code [s | e (n_exp) | m (n_mant)] -> (-1)^s * 2^(e + e_min) * (1 + m / 2^n_mant),
//   with e = m = 0 decoding to (signed) zero.
//
// Why bf16 tensor cores keep fp32 parity (split_mma.cuh): a decoded weight
// has at most 6 mantissa bits (n_bits <= 8) and bf16 has 7, so the decode
// builds the bf16 bits directly (exponent field e + e_min + 127, mantissa
// m << (7 - n_mant)) and is exact; x is split exactly into x0 + x1 + x2 of
// bf16; so x @ W = x2@W + x1@W + x0@W with every product exact, and only the
// float32 accumulation order differs from an SGEMM.  Each 32-deep k-step's
// three passes (small terms first) go into a fresh tensor-core accumulator,
// promoted into the float32 accumulator with a round-to-nearest add.
//
// Bound on the H100 at the main path's shapes (M = 2048; K x N = 768 x 768,
// 768 x 3072, 3072 x 768): operations.  One layer is 29 GFLOP of fp32 work
// (0.433 ms at the 67 TFLOP/s fp32 rate) or 87 GFLOP of bf16 tensor-core
// work in three passes (0.088 ms at 989 TFLOP/s), against ~45 MB moved
// (~0.013 ms).  Design:
//   * a 128 x 128 output tile per 256-thread block, 8 warps of 64 x 32, k
//     in steps of 32 through a 4-stage ring of {x fp32 tile, code tile} in
//     dynamic shared memory, filled by 16-byte cp.async (zero fill at the
//     edges); rows that are not 16-byte aligned (K % 4, N % 16 != 0) take
//     synchronous scalar loads into the same ring;
//   * x is read from shared memory into A fragments and split once per
//     k16 step, then reused across the warp's four n8 tiles;
//   * codes are decoded straight into B fragments, two at a time in the
//     halves of a register.  Within a warp's 32 columns, n8 tile j, column
//     g is column 4g + j, so one 32-bit shared load gives a lane its codes
//     for all four tiles;
//   * when the grid has fewer blocks than the card has SMs (late layers,
//     M = 128 * active sentences; the off-ramp, M <= 16), K is split over a
//     cluster of up to 8 blocks and the partial tiles are summed through
//     distributed shared memory in rank order: no atomics, the same bits on
//     every launch.  The wrapper (kernels/adaptivfloat_k.py) picks the split;
//     an unsplit grid is launched as clusters of one block.
#include "split_mma.cuh"

namespace {

using namespace split_mma;

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int STAGES = 4;
constexpr int kThreads = 256;
constexpr int XS = BK + 8;        // x tile row stride (floats): conflict-free float2 reads
constexpr int CS = BN + 16;       // code tile row stride (bytes): conflict-free 32-bit reads
constexpr int PS = BN + 1;        // partial tile row stride (floats)
constexpr int X_BYTES = BM * XS * 4;
constexpr int STAGE_BYTES = X_BYTES + BK * CS;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
static_assert(X_BYTES % 16 == 0 && STAGE_BYTES % 16 == 0, "cp.async needs 16-byte alignment");
static_assert(BM * PS * 4 <= SMEM_BYTES, "the partial tile reuses the ring");

bool g_opted_in[64];   // per device

// Two AF codes, one in the low byte of each 16-bit half of v, -> the bf16x2
// bits of their decoded values (exact).
__device__ __forceinline__ uint32_t af_bf16x2(uint32_t v, uint32_t sign_mask, int sign_shift,
                                              uint32_t mag_mask, int mant_shift, uint32_t ebias2) {
  const uint32_t sign = (v & sign_mask) << sign_shift;
  const uint32_t mag = v & mag_mask;
  // 0xffff in each half whose magnitude bits are not all zero
  const uint32_t nz = (((mag + 0x7fff7fffu) >> 15) & 0x00010001u) * 0xffffu;
  return (((mag << mant_shift) + ebias2) & nz) | sign;
}

__global__ void __launch_bounds__(kThreads, 1)
af_matmul_kernel(float* __restrict__ out, const float* __restrict__ x,
                 const uint8_t* __restrict__ codes, int M, int K, int N, int e_min, int n_bits,
                 int n_exp, int x_vec, int c_vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = split_size(), rank = split_rank();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // this block's slice of the k-steps
  const int KT = (K + BK - 1) / BK;
  const int kt0 = rank * KT / S, nkt = (rank + 1) * KT / S - kt0;

  // decode constants: sign to bit 15, exponent and mantissa fields into place
  const int n_mant = n_bits - 1 - n_exp;
  const uint32_t sign_mask = (1u << (n_bits - 1)) * 0x00010001u;
  const uint32_t mag_mask = ((1u << (n_bits - 1)) - 1u) * 0x00010001u;
  const int sign_shift = 16 - n_bits, mant_shift = 7 - n_mant;
  const uint32_t ebias2 = (static_cast<uint32_t>(e_min + 127) << 7) * 0x00010001u;

  auto load_stage = [&](int buf, int kt) {
    float* xs = reinterpret_cast<float*>(smem + buf * STAGE_BYTES);
    uint8_t* cs = smem + buf * STAGE_BYTES + X_BYTES;
    const int k0 = kt * BK;
    if (x_vec) {
#pragma unroll
      for (int i = 0; i < (BM * BK / 4) / kThreads; ++i) {
        const int q = tid + i * kThreads, row = q >> 3, c = (q & 7) * 4;
        const int gm = m0 + row, gk = k0 + c;
        const bool ok = gm < M && gk < K;
        cp_async16(xs + row * XS + c, x + (ok ? static_cast<long>(gm) * K + gk : 0), ok ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < (BM * BK) / kThreads; ++i) {
        const int e = tid + i * kThreads, row = e >> 5, c = e & 31;
        const int gm = m0 + row, gk = k0 + c;
        xs[row * XS + c] = (gm < M && gk < K) ? x[static_cast<long>(gm) * K + gk] : 0.f;
      }
    }
    if (c_vec) {
      static_assert((BK * BN / 16) == kThreads, "one 16-byte code chunk per thread");
      const int row = tid >> 3, c = (tid & 7) * 16;
      const int gk = k0 + row, gn = n0 + c;
      const bool ok = gk < K && gn < N;
      cp_async16(cs + row * CS + c, codes + (ok ? static_cast<long>(gk) * N + gn : 0), ok ? 16 : 0);
    } else {
#pragma unroll 4
      for (int i = 0; i < (BK * BN) / kThreads; ++i) {
        const int e = tid + i * kThreads, row = e >> 7, c = e & 127;
        const int gk = k0 + row, gn = n0 + c;
        cs[row * CS + c] = (gk < K && gn < N) ? codes[static_cast<long>(gk) * N + gn] : 0;
      }
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nkt) load_stage(s, kt0 + s);
    cp_async_commit();
  }

  for (int it = 0; it < nkt; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int pre = it + STAGES - 1;
    if (pre < nkt) load_stage(pre % STAGES, kt0 + pre);
    cp_async_commit();

    const float* xs = reinterpret_cast<const float*>(smem + (it % STAGES) * STAGE_BYTES);
    const uint8_t* cs = smem + (it % STAGES) * STAGE_BYTES + X_BYTES;
    float tc[4][4][4];
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      // B fragments: rows k = 2t, 2t+1, 2t+8, 2t+9 of this k16 step, columns
      // wn + 4g + j for n8 tile j (bytes j of one 32-bit word per row)
      const uint8_t* crow = cs + (ks * 16 + 2 * t) * CS + wn + 4 * g;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(crow);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(crow + CS);
      const uint32_t w2 = *reinterpret_cast<const uint32_t*>(crow + 8 * CS);
      const uint32_t w3 = *reinterpret_cast<const uint32_t*>(crow + 9 * CS);
      uint32_t b[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t sel = j | (j << 4) | ((j + 4) << 8) | ((j + 4) << 12);
        b[j][0] = af_bf16x2(__byte_perm(w0, w1, sel), sign_mask, sign_shift, mag_mask, mant_shift, ebias2);
        b[j][1] = af_bf16x2(__byte_perm(w2, w3, sel), sign_mask, sign_shift, mag_mask, mant_shift, ebias2);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* xr = xs + (wm + 16 * i + g) * XS + ks * 16 + 2 * t;
        const float2 v00 = *reinterpret_cast<const float2*>(xr);
        const float2 v10 = *reinterpret_cast<const float2*>(xr + 8 * XS);
        const float2 v01 = *reinterpret_cast<const float2*>(xr + 8);
        const float2 v11 = *reinterpret_cast<const float2*>(xr + 8 * XS + 8);
        uint32_t a0[4], a1[4], a2[4];
        split3(v00.x, v00.y, a0[0], a1[0], a2[0]);
        split3(v10.x, v10.y, a0[1], a1[1], a2[1]);
        split3(v01.x, v01.y, a0[2], a1[2], a2[2]);
        split3(v11.x, v11.y, a0[3], a1[3], a2[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (ks == 0) {
            mma_zero(tc[i][j], a2, b[j]);
          } else {
            mma(tc[i][j], a2, b[j]);
          }
          mma(tc[i][j], a1, b[j]);
          mma(tc[i][j], a0, b[j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) promote(acc[i][j], tc[i][j]);
  }
  cp_async_wait<0>();
  __syncthreads();

  // this block's partial tile into shared memory (the ring is free now)
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = wm + 16 * i + g + 8 * (r >> 1);
        const int col = wn + 4 * (2 * t + (r & 1)) + j;
        part[row * PS + col] = acc[i][j][r];
      }
  reduce_store(part, BM, BN, PS, [&](int r, int c, float v) {
    const int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N) out[static_cast<long>(gm) * N + gn] = v;
  });
}

}  // namespace

// Dynamic shared memory per block (the ring), for the build report.
REPRO_EXPORT int repro_smem_bytes() { return SMEM_BYTES; }

// x [M, K] fp32, codes [K, N] uint8, out [M, N] fp32, all contiguous.  K is
// split over clusters of `split` (1..8) blocks.  AF(n_bits, n_exp) with
// n_bits <= 8 and every decoded exponent e + e_min in [-126, 127].
REPRO_EXPORT int repro_af_matmul(float* out, const float* x, const uint8_t* codes, int M, int K,
                                 int N, int e_min, int n_bits, int n_exp, int split, void* stream,
                                 int device) {
  const DeviceScope scope(device);
  cudaError_t err = scope.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_mant = n_bits - 1 - n_exp;
  if (n_bits > 8 || n_exp < 1 || n_mant < 0 || split < 1 || split > 8 || e_min + 127 < 1 ||
      e_min + 127 + (1 << n_exp) - 1 > 254 || M < 0 || K < 0 || N < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  const int x_vec = (K % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const int c_vec = (N % 16 == 0) && (reinterpret_cast<uintptr_t>(codes) % 16 == 0);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, split);
  return static_cast<int>(split_mma::launch_split(
      af_matmul_kernel, grid, kThreads, SMEM_BYTES, static_cast<cudaStream_t>(stream), device,
      g_opted_in, out, x, codes, M, K, N, e_min, n_bits, n_exp, x_vec, c_vec));
}

// The weight-only GeMM on the tensor cores, shared by int4_gemm.cu and
// the float-lhs form of quant_gemm.cu, for Hopper (sm_90a):
// out (M, N) = (a (M, K) @ w (K, N)) * scale[col], a float32 or bfloat16,
// w int8 (one weight a byte) or int4 (two signed nibbles a byte along K),
// f32 sums, out float32 or bfloat16 rounded once in the epilogue.
//
// Bound on this card: at the prefill width (M = 128) the products -- each
// weight feeds 2 * 128 FLOP, far above bf16's ~295 FLOP per HBM byte at
// half a byte a weight, three times over for a float32 lhs (below).
//
// Design (mma.cuh's tile, stage ring and epilogue; fp8_gemm.cu's split-K):
//   * The weight streams through the ring of cp.async stages at its own
//     width: one byte (int8) or half a byte (int4) per weight.  After a
//     stage lands, a pass decodes it to bfloat16 in shared memory (every
//     int8 and int4 value is a bfloat16 value, so the decode is exact),
//     which ldmatrix.trans reads as the B fragments of
//     mma.sync.m16n8k16 bf16 x bf16 -> f32.
//   * A bfloat16 lhs is read in place from its stage as the A fragments.
//     A float32 lhs is read from HBM once, as float32, and the same pass
//     splits each value into three bfloat16 terms with a = a0 + a1 + a2
//     exactly (f32_terms.cuh: split3).  Each ai * w is exact in the
//     tensor core, so the kernel computes the reference's function -- f32
//     sums of a * w -- in another order.  a0's products accumulate apart
//     from a1's and a2's (2^-8 of their size), so the two small terms add
//     no rounding of the large sum.  Not TF32 (10 bits of a), nor two
//     terms (16 bits).
//   * Stages: 4, or 3 for a float32 lhs, whose A stage takes 34 KB at
//     BM = 128 (with the three term tiles, 197 KB of shared memory).
//   Ragged K or N, or an operand not 16-byte aligned, take the same
//   pipeline with element loads (synchronous) instead of cp.async.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "dtypes.cuh"
#include "f32_terms.cuh"
#include "mma.cuh"
#include "split_k.cuh"

constexpr int kWoAS = kBK + 8;   // bf16 row stride of an A tile (144 B)
constexpr int kWoBS = kBN + 8;   // bf16 row stride of the B tile (272 B)

__device__ __forceinline__ unsigned bf16x2(int lo, int hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn((float)lo, (float)hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ void store_row16(uint16_t* dst,
                                            const unsigned (&h)[8]) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(dst + 8) = make_uint4(h[4], h[5], h[6], h[7]);
}

// int8: byte row r of a stage is K row r
struct Int8Weight {
  static constexpr int kRows = kBK;      // byte rows a stage holds
  __device__ static int row_of(int k) { return k; }
  __device__ static int rows_end(int kend) { return kend; }
  // 16 bytes of byte row r at src -> B16 row r, columns c .. c + 15
  __device__ static void decode(const uint8_t* src, uint16_t* B16, int r,
                                int c) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
    unsigned h[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[2 * i] = bf16x2((int8_t)w[i], (int8_t)(w[i] >> 8));
      h[2 * i + 1] = bf16x2((int8_t)(w[i] >> 16), (int8_t)(w[i] >> 24));
    }
    store_row16(B16 + r * kWoBS + c, h);
  }
};

// int4: byte row r holds K rows 2r (low nibbles) and 2r + 1 (high); an odd
// K's last high nibble is a zero pad
struct Int4Weight {
  static constexpr int kRows = kBK / 2;
  __device__ static int row_of(int k) { return k / 2; }
  __device__ static int rows_end(int kend) { return (kend + 1) / 2; }
  __device__ static void decode(const uint8_t* src, uint16_t* B16, int r,
                                int c) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
    unsigned lo[8], hi[8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int p = 0; p < 2; ++p) {   // bytes 2p and 2p + 1 of word i
        const int s = 16 * p;
        // a nibble's sign bit shifted to bit 31, then shifted back down
        lo[2 * i + p] = bf16x2((int)(w[i] << (28 - s)) >> 28,
                               (int)(w[i] << (20 - s)) >> 28);
        hi[2 * i + p] = bf16x2((int)(w[i] << (24 - s)) >> 28,
                               (int)(w[i] << (16 - s)) >> 28);
      }
    store_row16(B16 + 2 * r * kWoBS + c, lo);
    store_row16(B16 + (2 * r + 1) * kWoBS + c, hi);
  }
};

template <int BM, typename TA, typename W>
struct Wo : WarpTiles<BM> {
  static constexpr bool kF32 = sizeof(TA) == 4;
  static constexpr int kTerms = kF32 ? 3 : 1;
  static constexpr int kStages = kF32 ? 3 : 4;
  // A stage row: kBK floats + 16 B, or kWoAS bf16 (read in place)
  static constexpr int kARow = kF32 ? 4 * kBK + 16 : 2 * kWoAS;
  static constexpr int kStageBytes = BM * kARow + W::kRows * kBN;
  static constexpr int kTermBytes = kF32 ? 2 * 3 * BM * kWoAS : 0;
  static constexpr int kSmem =
      kStages * kStageBytes + kTermBytes + 2 * kBK * kWoBS;
  static_assert(kSmem <= 232448, "over the 227 KB a CTA can have");
};

// one stage: a[m0 : m0+BM, k0 : k0+kBK] and the weight's byte rows of K
// rows k0 .. k0+kBK, columns n0 : n0+kBN, zero past M, N and kend.  VEC:
// 16-byte cp.async (K a multiple of 16 bytes of a, N of 16).
template <int BM, bool VEC, typename TA, typename W>
__device__ __forceinline__ void load_wo(uint8_t* as, uint8_t* ws,
                                        const TA* __restrict__ a,
                                        const uint8_t* __restrict__ w,
                                        int M, int K, int N, int m0, int n0,
                                        int k0, int kend) {
  using C = Wo<BM, TA, W>;
  constexpr int kPer = 16 / sizeof(TA);      // elements of a 16-byte piece
  constexpr int kPieces = kBK / kPer;        // pieces of an A row
  for (int c = threadIdx.x; c < BM * kPieces; c += kTcThreads) {
    const int r = c / kPieces, q = c % kPieces;
    const int m = m0 + r, k = k0 + kPer * q;
    uint8_t* dst = as + r * C::kARow + 16 * q;
    if (VEC) {
      const bool ok = m < M && k < kend;
      cp_async16(dst, ok ? a + (long long)m * K + k : a, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        reinterpret_cast<TA*>(dst)[j] = (m < M && k + j < kend)
                                            ? a[(long long)m * K + k + j]
                                            : narrow<TA>(0.f);
    }
  }
  const int r0 = W::row_of(k0), rend = W::rows_end(kend);
  for (int c = threadIdx.x; c < W::kRows * (kBN / 16); c += kTcThreads) {
    const int r = c / (kBN / 16), q = c % (kBN / 16);
    const int row = r0 + r, n = n0 + 16 * q;
    uint8_t* dst = ws + r * kBN + 16 * q;
    if (VEC) {
      const bool ok = row < rend && n < N;
      cp_async16(dst, ok ? w + (long long)row * N + n : w, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        dst[j] = (row < rend && n + j < N) ? w[(long long)row * N + n + j]
                                           : 0;
    }
  }
}

// grid (ceil(N / kBN), ceil(M / BM), ksplit); chunk z covers K rows
// [z * kc, min(K, (z + 1) * kc)), kc a multiple of kBK (whole packed bytes
// for int4).  dst: the output (TO, scaled) when ksplit == 1, else the
// float32 partial planes (ksplit, M, N).  Tag names the calling library's
// kernels in a profile.
template <typename Tag, typename W, int BM, bool VEC, typename TA,
          typename TO>
__global__ void __launch_bounds__(kTcThreads)
wo_tc(const TA* __restrict__ a, const uint8_t* __restrict__ w,
      const float* __restrict__ scale, void* __restrict__ dst, int M, int K,
      int N, int kc) {
  using C = Wo<BM, TA, W>;
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* At = reinterpret_cast<uint16_t*>(smem + C::kStages *
                                             C::kStageBytes);
  uint16_t* B16 = At + C::kTermBytes / 2;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int k0 = blockIdx.z * kc, kend = min(K, k0 + kc);
  const int nt = (kend - k0 + kBK - 1) / kBK;

  // acc: the products of a (bfloat16) or of a0; lo: those of a1 and a2
  float acc[C::MT][C::NT][4], lo[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = lo[i][j][e] = 0.f;

  auto stage_a = [&](int s) { return smem + s * C::kStageBytes; };
  auto stage_w = [&](int s) {
    return smem + s * C::kStageBytes + BM * C::kARow;
  };
  auto load = [&](int s, int t) {
    load_wo<BM, VEC, TA, W>(stage_a(s), stage_w(s), a, w, M, K, N, m0, n0,
                            k0 + t * kBK, kend);
  };
  auto compute = [&](int s) {
    const uint8_t* as = stage_a(s);
    if constexpr (C::kF32) {
      for (int c = tid; c < BM * (kBK / 4); c += kTcThreads) {
        const int r = c / (kBK / 4), q = c % (kBK / 4);
        const float4 v =
            *reinterpret_cast<const float4*>(as + r * C::kARow + 16 * q);
        unsigned x[3], y[3], z[3], u[3];
        split3(v.x, x);
        split3(v.y, y);
        split3(v.z, z);
        split3(v.w, u);
#pragma unroll
        for (int e = 0; e < 3; ++e)
          *reinterpret_cast<uint2*>(At + (e * BM + r) * kWoAS + 4 * q) =
              make_uint2(hi_halves(x[e], y[e]), hi_halves(z[e], u[e]));
      }
    }
    const uint8_t* ws = stage_w(s);
    for (int c = tid; c < W::kRows * (kBN / 16); c += kTcThreads) {
      const int r = c / (kBN / 16), q = c % (kBN / 16);
      W::decode(ws + r * kBN + 16 * q, B16, r, 16 * q);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      unsigned bf[C::NT][2];
#pragma unroll
      for (int j = 0; j < C::NT; j += 2) {
        const int row = kk + lane % 8 + 8 * ((lane / 8) % 2);
        const int col = wn * C::WTN + 8 * j + 8 * (lane / 16);
        unsigned r[4];
        ldsm_x4_t(r, B16 + row * kWoBS + col);
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int e = 0; e < C::kTerms; ++e) {
        const uint16_t* at = C::kF32
            ? At + e * BM * kWoAS
            : reinterpret_cast<const uint16_t*>(as);
        unsigned af[C::MT][4];
#pragma unroll
        for (int i = 0; i < C::MT; ++i) {
          const int row = wm * C::WTM + 16 * i + lane % 16;
          ldsm_x4(af[i], at + row * kWoAS + kk + 8 * (lane / 16));
        }
#pragma unroll
        for (int i = 0; i < C::MT; ++i)
#pragma unroll
          for (int j = 0; j < C::NT; ++j)
            mma16816_bf16(e == 0 ? acc[i][j] : lo[i][j], af[i], bf[j][0],
                          bf[j][1]);
      }
    }
  };
  stage_ring<C::kStages>(nt, load, compute);
  if constexpr (C::kF32) {
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
#pragma unroll
      for (int j = 0; j < C::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += lo[i][j][e];
  }
  store_acc<TO>(acc, scale, dst, M, N, m0 + wm * C::WTM, n0 + wn * C::WTN);
}

template <typename Tag, typename W, int BM, bool VEC, typename TA,
          typename TO>
int launch_wo(const TA* a, const uint8_t* w, const float* scale,
              float* partial, void* out, int M, int K, int N, int kc,
              int ksplit, cudaStream_t stream) {
  constexpr int smem = Wo<BM, TA, W>::kSmem;
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        wo_tc<Tag, W, BM, VEC, TA, TO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, ksplit);
  wo_tc<Tag, W, BM, VEC, TA, TO><<<grid, kTcThreads, smem, stream>>>(
      a, w, scale, ksplit == 1 ? out : static_cast<void*>(partial), M, K, N,
      kc);
  if (ksplit > 1)
    launch_split_k_sum<Tag, TO>(partial, scale, static_cast<TO*>(out), N,
                                (long long)M * N, ksplit, stream);
  return (int)cudaGetLastError();
}

// The weight-only GeMM for the C entries: a (M, K) float32 or (a_bf16)
// bfloat16, w the weight's byte rows (K, N) int8 or (ceil(K/2), N) packed
// int4, out float32 or (out_bf16) bfloat16, partial (ksplit, M, N)
// float32 scratch (unused when ksplit == 1); bm, kc and ksplit as the
// wrapper's planner gives them.
template <typename Tag, typename W>
int run_wo(const void* a, const uint8_t* w, const float* scale,
           float* partial, void* out, int M, int K, int N, int bm, int kc,
           int ksplit, int a_bf16, int out_bf16, cudaStream_t stream) {
  if (!tc_grid_ok(M, K, N, bm, kc, ksplit))
    return (int)cudaErrorInvalidValue;
  const bool vec = K % (a_bf16 ? 8 : 4) == 0 && N % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  auto go = [&](auto ta, auto to) {
    using TA = decltype(ta);
    using TO = decltype(to);
    const TA* at = static_cast<const TA*>(a);
    return with_bm(bm, [&](auto BM) {
      constexpr int bm_ = decltype(BM)::value;
      return vec ? launch_wo<Tag, W, bm_, true, TA, TO>(
                       at, w, scale, partial, out, M, K, N, kc, ksplit,
                       stream)
                 : launch_wo<Tag, W, bm_, false, TA, TO>(
                       at, w, scale, partial, out, M, K, N, kc, ksplit,
                       stream);
    });
  };
  if (a_bf16)
    return out_bf16 ? go(bf16(), bf16()) : go(bf16(), 0.f);
  return out_bf16 ? go(0.f, bf16()) : go(0.f, 0.f);
}

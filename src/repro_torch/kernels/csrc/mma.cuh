// What the split-K tensor-core GeMMs (fp8_gemm, quant_gemm, int4_gemm)
// share: the CTA tile and its warp layout, ldmatrix reads, mma.sync
// products, the main loop over a ring of cp.async stages, and the
// epilogue that writes a warp's accumulators to the output or to its K
// chunk's partial plane.
//
// Every one of these kernels runs kTcThreads threads on a (BM, kBN) output
// tile, BM in {16, 32, 64, 128}, over K chunks of whole kBK-deep stages;
// quant_gemm.py's planner (tc_split_k) copies kBN and kBK, and each
// library exports them (<name>_tiles) for the wrapper to check.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"
#include "dtypes.cuh"
#include "split_k.cuh"

constexpr int kTcThreads = 256;   // 8 warps
constexpr int kBN = 128;          // output columns per CTA
constexpr int kBK = 64;           // K depth of one stage

// the warps of a (BM, kBN) tile: WM x WN warps, each (WTM, WTN) of MT x NT
// m16n8 accumulator tiles
template <int BM>
struct WarpTiles {
  static constexpr int WM = BM >= 64 ? 2 : 1;   // warps along M
  static constexpr int WN = 8 / WM;             // warps along N
  static constexpr int WTM = BM / WM;           // a warp's rows
  static constexpr int WTN = kBN / WN;          // a warp's columns
  static constexpr int MT = WTM / 16;           // m16 tiles per warp
  static constexpr int NT = WTN / 8;            // n8 tiles per warp (even)
};

// true when the grid (ceil(N / kBN), ceil(M / bm), ksplit) covers K in
// chunks of kc rows, whole stages unless there is one chunk
inline bool tc_grid_ok(int M, int K, int N, int bm, int kc, int ksplit) {
  return M >= 1 && K >= 1 && N >= 1 && bm >= 16 && kc >= 1 &&
         ksplit >= 1 && ksplit <= 65535 && (M + bm - 1) / bm <= 65535 &&
         (long long)kc * ksplit >= K && (ksplit == 1 || kc % kBK == 0);
}

// f(std::integral_constant<int, BM>) for the CTA rows the planner picked
// (read BM as decltype(arg)::value)
template <typename F>
int with_bm(int bm, F&& f) {
  switch (bm) {
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    case 128: return f(std::integral_constant<int, 128>());
  }
  return (int)cudaErrorInvalidValue;
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) @ b (16 x 8, col), fp16 in, f32 accumulator
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the same with bfloat16 in
__device__ __forceinline__ void mma16816_bf16(float (&d)[4],
                                              const unsigned (&a)[4],
                                              unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16 x 32, row) @ b (32 x 8, col), int8 in, int32 accumulator
// (exact); each register holds four neighbouring k of one row or column
__device__ __forceinline__ void mma16832_s8(int (&d)[4],
                                            const unsigned (&a)[4],
                                            unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The int8 weight of the s8 GeMMs is N-major, but the s8 B fragment wants
// four neighbouring k of one column in each register, and ldmatrix.trans
// moves 16-bit elements only; so a landed stage (KR K rows of BN bytes) is
// transposed in 4 x 4 byte blocks into a K-major tile (BN rows of LDT
// bytes), which ldmatrix then reads as the B fragments.
//
// The 16-byte chunk q of K row r of such a stage sits at chunk
// s8_chunk<BN>(r, q): at BN = 128 the transpose's reads of four K words
// then fall in distinct banks (narrower stages keep what fits).
template <int BN>
__device__ __forceinline__ int s8_chunk(int r, int q) {
  return q ^ ((r >> 1) & 6 & (BN / 16 - 1));
}

// rows r[0..3] (4 bytes each) -> columns: r[j] byte i = old r[i] byte j
__device__ __forceinline__ void transpose4x4(unsigned (&r)[4]) {
  const unsigned t0 = __byte_perm(r[0], r[1], 0x5140);
  const unsigned t1 = __byte_perm(r[2], r[3], 0x5140);
  const unsigned t2 = __byte_perm(r[0], r[1], 0x7362);
  const unsigned t3 = __byte_perm(r[2], r[3], 0x7362);
  r[0] = __byte_perm(t0, t1, 0x5410);
  r[1] = __byte_perm(t0, t1, 0x7632);
  r[2] = __byte_perm(t2, t3, 0x5410);
  r[3] = __byte_perm(t2, t3, 0x7632);
}

// The stage b8 (KR x BN bytes, chunks by s8_chunk) -> bt (BN rows of LDT
// bytes).  A warp takes 4 K words x 8 N words (4 x 4 bytes each) a round:
// at BN = 128 its reads hit 32 banks through the swizzle, and its writes
// because each thread starts its four row writes at row (its N word % 8)
// / 2 of its block.  KR is a multiple of 16, BN of 32.
template <int KR, int BN, int LDT>
__device__ __forceinline__ void transpose_s8(const uint8_t* b8,
                                             uint8_t* bt) {
  constexpr int kUnits = (KR / 16) * (BN / 32);
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int wu = threadIdx.x / 32; wu < kUnits; wu += kTcThreads / 32) {
    const int kb = 4 * (wu % (KR / 16)) + lane % 4;  // K rows 4 kb .. + 3
    const int nb = 8 * (wu / (KR / 16)) + lane / 4;  // columns 4 nb .. + 3
    unsigned r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 4 * kb + i;
      r[i] = *reinterpret_cast<const unsigned*>(
          b8 + row * BN + 16 * s8_chunk<BN>(row, nb / 4) + 4 * (nb % 4));
    }
    transpose4x4(r);
    const int rot = (nb % 8) / 2;   // r[j] -> r[(j + rot) % 4]
    if (rot & 1) {
      const unsigned x = r[0];
      r[0] = r[1];
      r[1] = r[2];
      r[2] = r[3];
      r[3] = x;
    }
    if (rot & 2) {
      unsigned x = r[0];
      r[0] = r[2];
      r[2] = x;
      x = r[1];
      r[1] = r[3];
      r[3] = x;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<unsigned*>(bt + (4 * nb + (j + rot) % 4) * LDT +
                                   4 * kb) = r[j];
  }
}

// The main loop over a ring of kStages shared-memory stages, called by
// every thread of the CTA: load(slot, t) issues the copies of stage t
// into ring slot `slot`, compute(slot) consumes a landed stage.  The loads
// of stage t + kStages - 1 are in flight while stage t is consumed.
template <int kStages, typename Load, typename Compute>
__device__ __forceinline__ void stage_ring(int nt, Load&& load,
                                           Compute&& compute) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nt) load(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage t landed; the slot of stage t - 1 is free
    const int next = t + kStages - 1;
    if (next < nt) load(next % kStages, next);
    cp_async_commit();
    compute(t % kStages);
  }
  cp_async_wait<0>();
}

// A warp's accumulators (TP float or int; its tiles at rows m0 + 16 i,
// columns n0 + 8 j), in pairs of neighbouring columns: with one K chunk
// (gridDim.z == 1) the output, TO(float(acc) * scale[col]); else this
// chunk's plane of the partial scratch (ksplit, M, N) of TP, as they are.
template <typename TO, typename TP, int MT, int NT>
__device__ __forceinline__ void store_acc(const TP (&acc)[MT][NT][4],
                                          const float* __restrict__ scale,
                                          void* __restrict__ dst, int M,
                                          int N, int m0, int n0) {
  const int lane = threadIdx.x % 32;
  const bool whole = gridDim.z == 1, vec = N % 2 == 0;
  TP* plane = static_cast<TP*>(dst) + (long long)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 16 * i + lane / 4 + 8 * h;
        const int n = n0 + 8 * j + 2 * (lane % 4);
        if (m >= M || n >= N) continue;
        const long long o = (long long)m * N + n;
        const bool two = n + 1 < N;
        const TP v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (whole)
          store2(static_cast<TO*>(dst) + o, __fmul_rn(to_f32(v0), scale[n]),
                 two ? __fmul_rn(to_f32(v1), scale[n + 1]) : 0.f, two, vec);
        else
          store2(plane + o, v0, v1, two, vec);
      }
}

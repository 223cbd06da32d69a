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

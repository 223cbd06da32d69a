// Quantized GeMM with a fused dequantize epilogue, for Hopper (sm_90a), on
// the CUDA cores: out (M, N) float32 = (a (M, K) @ b (K, N)) * scale[col],
// with b int8 and a either
//   int8    (int32 accumulation, four products per __dp4a), or
//   float   (weight-only, float32 or bfloat16: each int8 weight, and a
//            bfloat16 lhs, is cast up to float32 after its load -- exact --
//            and the products accumulate in float32).
//
// Replaces: src/repro/kernels/quant_gemm.py::quant_gemm (pallas_call at
// quant_gemm.py:106), the TPU kernel with an (M, N, K) grid, a VMEM
// accumulator and the epilogue acc.astype(f32) * scale at the last K step.
//
// Bound on this card: bytes for the shapes the model sends it (the ResNet
// head at M = 8 or 32 reads a 2048 x 1000 int8 weight once); operations
// only for large M, against the 1,979 TOP/s int8 tensor-core rate, which
// this kernel does not use (__dp4a and fp32 FMA on the CUDA cores; the
// mma/wgmma s8 version is later work).
//
// Design: the OS loop order only -- as the reference, which takes the
// mapper's block and drops its order.  A CTA of 256 threads owns one
// (BM, BN) output tile, BM, BN in {32, 64, 128}, walks all of K, and each
// thread keeps a (BM/16) x (BN/16) register tile whose rows and columns
// are strided by 16 (a warp's B reads hit 16 neighbouring banks, its A
// reads are broadcasts).  int8 mode: K is walked 32 deep; both tiles sit in
// shared memory as int32 words packing 4 consecutive k (A row-wise, B
// column-wise), so one word pair is one __dp4a.  Weight-only mode: the
// float kernel's 16-deep f32 tiles, B converted to float as it is stored.
// Ragged edges are masked with zeros in the loads (zero is exact in both
// modes); no padded copy of an operand exists.  The epilogue is float(acc)
// first, then one multiply by scale[col].

#include <cuda_runtime.h>
#include <stdint.h>

#include "dtypes.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kStep8 = 32;     // K depth of one int8 step
constexpr int kWords = kStep8 / 4;
constexpr int kStepF = 16;     // K depth of one weight-only step

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads)
qgemm_s8(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
         const float* __restrict__ scale, float* __restrict__ out, int M,
         int K, int N, int nn) {
  constexpr int TM = BM / 16, TN = BN / 16;
  __shared__ int As[kWords][BM + 1];  // As[q][r]: a[m0+r][k0+4q .. +3]
  __shared__ int Bs[kWords][BN];      // Bs[q][c]: b[k0+4q .. +3][n0+c]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = (blockIdx.x / nn) * BM, n0 = (blockIdx.x % nn) * BN;
  int acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0;

  for (int k0 = 0; k0 < K; k0 += kStep8) {
    for (int e = tid; e < BM * kWords; e += kThreads) {
      const int r = e / kWords, q = e % kWords;
      const int m = m0 + r, k = k0 + 4 * q;
      unsigned u = 0;
      if (m < M)
        for (int j = 0; j < 4 && k + j < K; ++j)
          u |= (unsigned)(uint8_t)a[(long long)m * K + k + j] << (8 * j);
      As[q][r] = (int)u;
    }
    for (int e = tid; e < kWords * BN; e += kThreads) {
      const int q = e / BN, c = e % BN;
      const int n = n0 + c, k = k0 + 4 * q;
      unsigned u = 0;
      if (n < N)
        for (int j = 0; j < 4 && k + j < K; ++j)
          u |= (unsigned)(uint8_t)b[(long long)(k + j) * N + n] << (8 * j);
      Bs[q][c] = (int)u;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      int av[TM], bv[TN];
#pragma unroll
      for (int r = 0; r < TM; ++r) av[r] = As[q][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < TN; ++c) bv[c] = Bs[q][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = __dp4a(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int m = m0 + ty + 16 * r;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int n = n0 + tx + 16 * c;
      if (n < N)
        out[(long long)m * N + n] =
            __fmul_rn(__int2float_rn(acc[r][c]), scale[n]);
    }
  }
}

template <int BM, int BN, typename TA>
__global__ void __launch_bounds__(kThreads)
qgemm_wo(const TA* __restrict__ a, const int8_t* __restrict__ b,
         const float* __restrict__ scale, float* __restrict__ out, int M,
         int K, int N, int nn) {
  constexpr int TM = BM / 16, TN = BN / 16;
  __shared__ float As[kStepF][BM + 1];
  __shared__ float Bs[kStepF][BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = (blockIdx.x / nn) * BM, n0 = (blockIdx.x % nn) * BN;
  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kStepF) {
    for (int e = tid; e < BM * kStepF; e += kThreads) {
      const int r = e / kStepF, c = e % kStepF;
      const int m = m0 + r, k = k0 + c;
      As[c][r] = (m < M && k < K) ? widen(a[(long long)m * K + k]) : 0.f;
    }
    for (int e = tid; e < kStepF * BN; e += kThreads) {
      const int r = e / BN, c = e % BN;
      const int k = k0 + r, n = n0 + c;
      Bs[r][c] = (k < K && n < N) ? (float)b[(long long)k * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kStepF; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int r = 0; r < TM; ++r) av[r] = As[kk][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < TN; ++c) bv[c] = Bs[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int m = m0 + ty + 16 * r;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int n = n0 + tx + 16 * c;
      if (n < N) out[(long long)m * N + n] = __fmul_rn(acc[r][c], scale[n]);
    }
  }
}

template <int BM, int BN>
void launch(const void* a, const int8_t* b, const float* scale, float* out,
            int M, int K, int N, int a_int8, int a_bf16,
            cudaStream_t stream) {
  const int nm = (M + BM - 1) / BM, nn = (N + BN - 1) / BN;
  if (a_int8)
    qgemm_s8<BM, BN><<<nm * nn, kThreads, 0, stream>>>(
        static_cast<const int8_t*>(a), b, scale, out, M, K, N, nn);
  else if (a_bf16)
    qgemm_wo<BM, BN, bf16><<<nm * nn, kThreads, 0, stream>>>(
        static_cast<const bf16*>(a), b, scale, out, M, K, N, nn);
  else
    qgemm_wo<BM, BN, float><<<nm * nn, kThreads, 0, stream>>>(
        static_cast<const float*>(a), b, scale, out, M, K, N, nn);
}

}  // namespace

// a (M, K) int8 (a_int8 = 1), float32 or bfloat16 (a_bf16 = 1), b (K, N)
// int8, scale (N,) float32, out (M, N) float32, all contiguous.  (bm, bn)
// is the CTA's output tile, each of 32, 64 or 128.
extern "C" int quant_gemm(const void* a, const int8_t* b, const float* scale,
                          float* out, int M, int K, int N, int bm, int bn,
                          int a_int8, int a_bf16, cudaStream_t stream) {
  if (M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
#define QGEMM_TILE(BM_, BN_)                                                 \
  if (bm == BM_ && bn == BN_) {                                              \
    launch<BM_, BN_>(a, b, scale, out, M, K, N, a_int8, a_bf16, stream);     \
    return (int)cudaGetLastError();                                          \
  }
  QGEMM_TILE(32, 32) QGEMM_TILE(32, 64) QGEMM_TILE(32, 128)
  QGEMM_TILE(64, 32) QGEMM_TILE(64, 64) QGEMM_TILE(64, 128)
  QGEMM_TILE(128, 32) QGEMM_TILE(128, 64) QGEMM_TILE(128, 128)
#undef QGEMM_TILE
  return (int)cudaErrorInvalidValue;
}

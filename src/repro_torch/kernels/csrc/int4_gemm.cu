// Weight-only GeMM against a nibble-packed int4 weight, for Hopper
// (sm_90a), on the CUDA cores: out (M, N) float32 = (a (M, K) @ w (K, N))
// * scale[col], with a float32 or bfloat16 (widened at its shared-memory
// store, exact) and w stored two signed nibbles per byte
// along K: packed (ceil(K/2), N) int8, byte (kp, n) = (w[2kp+1][n] << 4) |
// (w[2kp][n] & 0xF).  An odd K pads its last byte's high nibble with 0.
//
// Replaces: src/repro/kernels/quant_gemm.py::int4_gemm (pallas_call at
// quant_gemm.py:244), the TPU kernel with an (M, N, K) grid that unpacks
// each (bk/2, bn) packed block in VMEM (sign-extending shifts, bk forced
// even), multiplies it in the activation dtype into an f32 accumulator and
// applies the column scale once, at the last K step.
//
// Bound on this card: operations.  At the prefill width (M = 128) each
// packed byte feeds 2 * 128 products, so the fp32 FMA rate (67 TFLOP/s;
// the kernel does not use the tensor cores) is the limit long before the
// half byte per weight.
//
// Design: quant_gemm.cu's weight-only path with the unpack fused into the
// shared-memory load.  A CTA of 256 threads owns one (BM, BN) output tile,
// BM, BN in {32, 64, 128}, and walks all of K 16 deep (so every step starts
// on an even k and reads whole packed rows: the kernel's bk is 16, even).
// Each thread turns one packed byte into two floats: the low nibble is
// (int8_t)(b << 4) >> 4 and the high one b >> 4, both arithmetic shifts.
// Each thread keeps a (BM/16) x (BN/16) register tile whose rows and
// columns are strided by 16.  Ragged edges (M, N, and k >= K) load zeros,
// which are exact.  The epilogue multiplies the f32 accumulator once by
// scale[col].

#include <cuda_runtime.h>
#include <stdint.h>

#include "dtypes.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kStep = 16;      // K depth of one step (even)

// (uint8_t) first: shifting a negative value left is undefined in C++17
__device__ __forceinline__ float lo_nibble(int8_t b) {
  return (float)((int8_t)((uint8_t)b << 4) >> 4);
}

__device__ __forceinline__ float hi_nibble(int8_t b) {
  return (float)(b >> 4);
}

template <int BM, int BN, typename TA>
__global__ void __launch_bounds__(kThreads)
int4_gemm_tile(const TA* __restrict__ a, const int8_t* __restrict__ w,
               const float* __restrict__ scale, float* __restrict__ out,
               int M, int K, int N, int nn) {
  constexpr int TM = BM / 16, TN = BN / 16;
  __shared__ float As[kStep][BM + 1];
  __shared__ float Bs[kStep][BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = (blockIdx.x / nn) * BM, n0 = (blockIdx.x % nn) * BN;
  const int Kp = (K + 1) / 2;
  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kStep) {
    for (int e = tid; e < BM * kStep; e += kThreads) {
      const int r = e / kStep, c = e % kStep;
      const int m = m0 + r, k = k0 + c;
      As[c][r] = (m < M && k < K) ? widen(a[(long long)m * K + k]) : 0.f;
    }
    for (int e = tid; e < (kStep / 2) * BN; e += kThreads) {
      const int r = e / BN, c = e % BN;
      const int kp = k0 / 2 + r, n = n0 + c;
      float lo = 0.f, hi = 0.f;
      if (kp < Kp && n < N) {
        const int8_t b = w[(long long)kp * N + n];
        lo = lo_nibble(b);
        if (2 * kp + 1 < K) hi = hi_nibble(b);
      }
      Bs[2 * r][c] = lo;
      Bs[2 * r + 1][c] = hi;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kStep; ++kk) {
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
void launch(const void* a, const int8_t* w, const float* scale, float* out,
            int M, int K, int N, int a_bf16, cudaStream_t stream) {
  const int nm = (M + BM - 1) / BM, nn = (N + BN - 1) / BN;
  if (a_bf16)
    int4_gemm_tile<BM, BN, bf16><<<nm * nn, kThreads, 0, stream>>>(
        static_cast<const bf16*>(a), w, scale, out, M, K, N, nn);
  else
    int4_gemm_tile<BM, BN, float><<<nm * nn, kThreads, 0, stream>>>(
        static_cast<const float*>(a), w, scale, out, M, K, N, nn);
}

}  // namespace

// a (M, K) float32 or (a_bf16 = 1) bfloat16, w (ceil(K/2), N) packed int8,
// scale (N,) float32, out (M, N) float32, all contiguous.  (bm, bn) is the
// CTA's output tile, each of 32, 64 or 128.
extern "C" int int4_gemm(const void* a, const int8_t* w, const float* scale,
                         float* out, int M, int K, int N, int bm, int bn,
                         int a_bf16, cudaStream_t stream) {
  if (M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
#define INT4_TILE(BM_, BN_)                                       \
  if (bm == BM_ && bn == BN_) {                                   \
    launch<BM_, BN_>(a, w, scale, out, M, K, N, a_bf16, stream);  \
    return (int)cudaGetLastError();                               \
  }
  INT4_TILE(32, 32) INT4_TILE(32, 64) INT4_TILE(32, 128)
  INT4_TILE(64, 32) INT4_TILE(64, 64) INT4_TILE(64, 128)
  INT4_TILE(128, 32) INT4_TILE(128, 64) INT4_TILE(128, 128)
#undef INT4_TILE
  return (int)cudaErrorInvalidValue;
}

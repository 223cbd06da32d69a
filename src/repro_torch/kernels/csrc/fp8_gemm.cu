// e4m3 GeMM with a column-scale epilogue, for Hopper (sm_90a), on the CUDA
// cores: out (M, N) float32 = (a (M, K) @ b (K, N)) * scale[col], with b
// e4m3 (float8_e4m3fn) and a either e4m3 or float32 (the weight-only
// form).  Every e4m3 value is decoded to float32 as it is stored in shared
// memory (exact: e4m3 -> half -> float loses nothing), and the products
// accumulate in float32 with fmaf, so the result is the reference's exact
// f32 product up to summation order.
//
// Replaces: src/repro/kernels/quant_gemm.py::fp8_gemm (pallas_call at
// quant_gemm.py:367), the TPU kernel with an (M, N, K) grid that casts
// both blocks to f32 in VMEM, accumulates in an f32 scratch and applies
// acc * scale at the last K step.
//
// Not FP8 wgmma: Hopper's FP8 tensor-core product accumulates at reduced
// precision (arXiv:2412.19437), which is not the reference's function; a
// later version may use it with promotion to an f32 accumulator every few
// K steps.
//
// Bound on this card: bytes at the shapes the LM sends it (every
// projection reads its K x N e4m3 weight once; 2 * M FLOP per weight byte
// is below the fp8 rate's ~590 FLOP per HBM byte for M <= 128), which this
// kernel does not reach: it runs fp32 FMA on the CUDA cores.
//
// Design: quant_gemm.cu's weight-only tile.  A CTA of 256 threads owns one
// (BM, BN) output tile, BM, BN in {32, 64, 128}, walks all of K (the OS
// order, as the reference takes the mapper's block and drops its order)
// 16 deep, and each thread keeps a (BM/16) x (BN/16) register tile whose
// rows and columns are strided by 16.  Ragged edges are masked with zeros
// in the loads (zero is exact); no padded copy of an operand exists.  The
// epilogue is one multiply by scale[col].

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kStep = 16;      // K depth of one shared-memory step

__device__ __forceinline__ float e4m3(uint8_t byte) {
  __nv_fp8_e4m3 v;
  v.__x = byte;
  return static_cast<float>(v);
}

__device__ __forceinline__ float load_a(const uint8_t* a, long long i) {
  return e4m3(a[i]);
}

__device__ __forceinline__ float load_a(const float* a, long long i) {
  return a[i];
}

template <int BM, int BN, typename TA>
__global__ void __launch_bounds__(kThreads)
fp8_gemm_tile(const TA* __restrict__ a, const uint8_t* __restrict__ b,
              const float* __restrict__ scale, float* __restrict__ out,
              int M, int K, int N, int nn) {
  constexpr int TM = BM / 16, TN = BN / 16;
  __shared__ float As[kStep][BM + 1];
  __shared__ float Bs[kStep][BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = (blockIdx.x / nn) * BM, n0 = (blockIdx.x % nn) * BN;
  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kStep) {
    for (int e = tid; e < BM * kStep; e += kThreads) {
      const int r = e / kStep, c = e % kStep;
      const int m = m0 + r, k = k0 + c;
      As[c][r] = (m < M && k < K) ? load_a(a, (long long)m * K + k) : 0.f;
    }
    for (int e = tid; e < kStep * BN; e += kThreads) {
      const int r = e / BN, c = e % BN;
      const int k = k0 + r, n = n0 + c;
      Bs[r][c] = (k < K && n < N) ? e4m3(b[(long long)k * N + n]) : 0.f;
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
void launch(const void* a, const uint8_t* b, const float* scale, float* out,
            int M, int K, int N, int a_fp8, cudaStream_t stream) {
  const int nm = (M + BM - 1) / BM, nn = (N + BN - 1) / BN;
  if (a_fp8)
    fp8_gemm_tile<BM, BN, uint8_t><<<nm * nn, kThreads, 0, stream>>>(
        static_cast<const uint8_t*>(a), b, scale, out, M, K, N, nn);
  else
    fp8_gemm_tile<BM, BN, float><<<nm * nn, kThreads, 0, stream>>>(
        static_cast<const float*>(a), b, scale, out, M, K, N, nn);
}

}  // namespace

// a (M, K) e4m3 bytes (a_fp8 = 1) or float32 (a_fp8 = 0), b (K, N) e4m3
// bytes, scale (N,) float32, out (M, N) float32, all contiguous.  (bm, bn)
// is the CTA's output tile, each of 32, 64 or 128.
extern "C" int fp8_gemm(const void* a, const uint8_t* b, const float* scale,
                        float* out, int M, int K, int N, int bm, int bn,
                        int a_fp8, cudaStream_t stream) {
  if (M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
#define FP8_TILE(BM_, BN_)                                             \
  if (bm == BM_ && bn == BN_) {                                        \
    launch<BM_, BN_>(a, b, scale, out, M, K, N, a_fp8, stream);        \
    return (int)cudaGetLastError();                                    \
  }
  FP8_TILE(32, 32) FP8_TILE(32, 64) FP8_TILE(32, 128)
  FP8_TILE(64, 32) FP8_TILE(64, 64) FP8_TILE(64, 128)
  FP8_TILE(128, 32) FP8_TILE(128, 64) FP8_TILE(128, 128)
#undef FP8_TILE
  return (int)cudaErrorInvalidValue;
}

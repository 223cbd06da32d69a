// Weight-only int8 GEMV, out (B, N) float32 = (x (B, K) @ w (K, N)) *
// scale[col], x float32 or bfloat16 (widened at the load, exact) with
// B <= 8, w int8, for Hopper (sm_90a), on the CUDA cores.
//
// Replaces: src/repro/kernels/quant_gemm.py::wq_gemv (pallas_call at
// quant_gemm.py:166), the TPU kernel that streams the int8 weight once
// over an (N blocks, K blocks) grid into a VMEM f32 accumulator and applies
// the column scale after the whole K loop.
//
// Bound on this card: bytes.  Each one-byte weight is used B <= 8 times, so
// the least time is the K * N weight bytes (plus x and out) over the HBM
// bandwidth -- a quarter of the float GEMV's.
//
// Design: gemv.cu's, with int8 weights.  Each thread owns one column and a
// warp reads 32 neighbouring bytes of one weight row; the int8 value is
// cast up to float after its load and multiplied into B f32 sums kept in
// registers, with the CTA's chunk of every x row in shared memory.  A
// ResNet head (N = 1000) gives only 8 column blocks for 132 SMs, so K is
// split into chunks of kc rows (the wrapper sizes kc to put about two CTAs
// on every SM); each chunk writes its partial sums to a scratch plane and
// a second pass adds the planes in a fixed order (no atomics, so the
// result is deterministic).  The column scale is applied once, after the
// split-K sum, as the reference applies it after its whole K loop.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dtypes.cuh"
#include "split_k.cuh"

namespace {

constexpr int kCols = 128;  // columns per CTA, one per thread
constexpr int kMaxB = 8;

struct wq_gemv_sum;  // names the split-K sum's instances in a profile

template <typename TX>
__global__ void __launch_bounds__(kCols)
wq_gemv_partial(const TX* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scale, float* __restrict__ dst,
                int B, int K, int N, int kc, int last) {
  extern __shared__ float xs[];  // (B, kc): this chunk of every x row
  const int n = blockIdx.x * kCols + threadIdx.x;
  const int k0 = blockIdx.y * kc;
  const int len = min(K, k0 + kc) - k0;
  for (int i = threadIdx.x; i < B * len; i += blockDim.x) {
    const int b = i / len, k = i - b * len;
    xs[b * kc + k] = widen(x[(long long)b * K + k0 + k]);
  }
  __syncthreads();
  if (n >= N) return;
  float acc[kMaxB];
#pragma unroll
  for (int b = 0; b < kMaxB; ++b) acc[b] = 0.f;
  const signed char* wp =
      reinterpret_cast<const signed char*>(w) + (long long)k0 * N + n;
#pragma unroll 8
  for (int k = 0; k < len; ++k) {
    const float wv = (float)__ldg(wp + (long long)k * N);
#pragma unroll
    for (int b = 0; b < kMaxB; ++b)
      if (b < B) acc[b] = fmaf(xs[b * kc + k], wv, acc[b]);
  }
  // one chunk (last = 1) is the whole sum: scale it here
  float* o = dst + (long long)blockIdx.y * B * N;
  const float s = scale[n];
#pragma unroll
  for (int b = 0; b < kMaxB; ++b)
    if (b < B) o[(long long)b * N + n] = last ? __fmul_rn(acc[b], s) : acc[b];
}

}  // namespace

// x (B, K) float32 or (x_bf16 = 1) bfloat16, w (K, N) int8, scale (N,)
// float32, out (B, N) float32, partial (ksplit, B, N) float32 scratch
// (unused when ksplit == 1); all contiguous, on the device of `stream`.
extern "C" int wq_gemv(const void* x, const int8_t* w, const float* scale,
                       float* partial, float* out, int B, int K, int N,
                       int kc, int ksplit, int x_bf16, cudaStream_t stream) {
  if (B < 1 || B > kMaxB || kc < 1 || ksplit < 1 ||
      (long long)kc * ksplit < K)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kCols - 1) / kCols, ksplit);
  const size_t smem = sizeof(float) * (size_t)B * kc;
  float* dst = ksplit == 1 ? out : partial;
  if (x_bf16)
    wq_gemv_partial<bf16><<<grid, kCols, smem, stream>>>(
        static_cast<const bf16*>(x), w, scale, dst, B, K, N, kc, ksplit == 1);
  else
    wq_gemv_partial<float><<<grid, kCols, smem, stream>>>(
        static_cast<const float*>(x), w, scale, dst, B, K, N, kc,
        ksplit == 1);
  if (ksplit > 1) {
    launch_split_k_sum<wq_gemv_sum, float>(partial, scale, out, N,
                                           (long long)B * N, ksplit, stream);
  }
  return (int)cudaGetLastError();
}

// Weight-only int4 GEMV, out (B, N) float32 = (x (B, K) @ w (K, N)) *
// scale[col], x float32 or bfloat16 (widened at the load, exact) with
// B <= 8 and w nibble-packed along K (packed
// (ceil(K/2), N) int8, byte (kp, n) = (w[2kp+1][n] << 4) | (w[2kp][n] &
// 0xF)), for Hopper (sm_90a), on the CUDA cores.
//
// Replaces: src/repro/kernels/quant_gemm.py::int4_gemv (pallas_call at
// quant_gemm.py:303), the TPU kernel that streams the packed weight once
// over an (N blocks, K blocks) grid (bk forced even), unpacks each block in
// VMEM into an f32 accumulator and applies the column scale after the whole
// K loop.
//
// Bound on this card: at B = 8 operations, barely: each half-byte weight
// feeds 8 FMAs, so 2 * 8 * K * N flops at 67 TFLOP/s fp32 outlast the
// K * N / 2 packed bytes at 3.35 TB/s (at B <= 4 the bytes bound it).
//
// Design: wq_gemv.cu's, with packed weights.  Each thread owns one column
// and a warp reads 32 neighbouring bytes of one packed row; each byte feeds
// two k rows (its low nibble (int8_t)(b << 4) >> 4, its high one b >> 4,
// arithmetic shifts) into B f32 sums kept in registers, with the CTA's
// chunk of every x row in shared memory.  K is split into chunks of kc rows
// (kc even, so a chunk starts on a whole packed row; the wrapper sizes kc
// to put about two CTAs on every SM); each chunk writes its partial sums to
// a scratch plane and a second pass adds the planes in a fixed order (no
// atomics, so the result is deterministic).  The column scale is applied
// once, after the split-K sum.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dtypes.cuh"
#include "split_k.cuh"

namespace {

constexpr int kCols = 128;  // columns per CTA, one per thread
constexpr int kMaxB = 8;

struct int4_gemv_sum;  // names the split-K sum's instances in a profile

template <typename TX>
__global__ void __launch_bounds__(kCols)
int4_gemv_partial(const TX* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, float* __restrict__ dst,
                  int B, int K, int N, int kc, int last) {
  extern __shared__ float xs[];  // (B, kc): this chunk of every x row
  const int n = blockIdx.x * kCols + threadIdx.x;
  const int k0 = blockIdx.y * kc;  // even: kc is even when ksplit > 1
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
      reinterpret_cast<const signed char*>(w) + (long long)(k0 / 2) * N + n;
  const int pairs = len / 2;
#pragma unroll 4
  for (int p = 0; p < pairs; ++p) {
    const signed char byte = __ldg(wp + (long long)p * N);
    // (unsigned char) first: shifting a negative value left is undefined
    const float lo = (float)((signed char)((unsigned char)byte << 4) >> 4);
    const float hi = (float)(byte >> 4);
#pragma unroll
    for (int b = 0; b < kMaxB; ++b)
      if (b < B) {
        acc[b] = fmaf(xs[b * kc + 2 * p], lo, acc[b]);
        acc[b] = fmaf(xs[b * kc + 2 * p + 1], hi, acc[b]);
      }
  }
  if (len % 2) {  // the last chunk of an odd K: a low nibble alone
    const signed char byte = __ldg(wp + (long long)pairs * N);
    const float lo = (float)((signed char)((unsigned char)byte << 4) >> 4);
#pragma unroll
    for (int b = 0; b < kMaxB; ++b)
      if (b < B) acc[b] = fmaf(xs[b * kc + len - 1], lo, acc[b]);
  }
  // one chunk (last = 1) is the whole sum: scale it here
  float* o = dst + (long long)blockIdx.y * B * N;
  const float s = scale[n];
#pragma unroll
  for (int b = 0; b < kMaxB; ++b)
    if (b < B) o[(long long)b * N + n] = last ? __fmul_rn(acc[b], s) : acc[b];
}

}  // namespace

// x (B, K) float32 or (x_bf16 = 1) bfloat16, w (ceil(K/2), N) packed
// int8, scale (N,) float32, out (B, N) float32, partial (ksplit, B, N)
// float32 scratch (unused when ksplit == 1); all contiguous, on the device
// of `stream`.  kc is the K rows per chunk, even unless one chunk covers
// all of K.
extern "C" int int4_gemv(const void* x, const int8_t* w, const float* scale,
                         float* partial, float* out, int B, int K, int N,
                         int kc, int ksplit, int x_bf16,
                         cudaStream_t stream) {
  if (B < 1 || B > kMaxB || kc < 1 || ksplit < 1 ||
      (long long)kc * ksplit < K || (ksplit > 1 && kc % 2))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kCols - 1) / kCols, ksplit);
  const size_t smem = sizeof(float) * (size_t)B * kc;
  float* dst = ksplit == 1 ? out : partial;
  if (x_bf16)
    int4_gemv_partial<bf16><<<grid, kCols, smem, stream>>>(
        static_cast<const bf16*>(x), w, scale, dst, B, K, N, kc, ksplit == 1);
  else
    int4_gemv_partial<float><<<grid, kCols, smem, stream>>>(
        static_cast<const float*>(x), w, scale, dst, B, K, N, kc,
        ksplit == 1);
  if (ksplit > 1) {
    launch_split_k_sum<int4_gemv_sum, float>(partial, scale, out, N,
                                             (long long)B * N, ksplit, stream);
  }
  return (int)cudaGetLastError();
}

// Small-batch float32 GEMV, out (B, N) = x (B, K) @ w (K, N), B <= 8,
// for Hopper (sm_90a), on the CUDA cores.
//
// Replaces: src/repro/kernels/gemv.py::gemv (pallas_call at gemv.py:59),
// the TPU kernel that streams W once over a (N blocks, K blocks) grid with
// a VMEM-resident f32 accumulator.
//
// Bound on this card: bytes.  Every weight is used B <= 8 times, so the
// kernel does at most 16 FLOP per 4-byte weight it reads -- far below the
// ~20 FLOP/byte at which the H100's float32 rate, not its HBM, would be
// the limit.  The least time is K * N * 4 bytes over the HBM bandwidth.
//
// Design: W is row-major (K, N); each thread owns one column and each warp
// reads 32 neighbouring columns of one row, so every W load is one
// coalesced 128-byte transaction and W is read exactly once.  The B rows of
// the CTA's K chunk sit in shared memory and each thread keeps B f32 sums
// in registers.  A ResNet head (N = 1000) gives only 8 column blocks for
// 132 SMs, so K is split into chunks of kc rows (the wrapper sizes kc to
// put about two CTAs on every SM): each chunk writes its partial sums to a
// scratch plane, and a second pass adds the planes in a fixed order -- no
// atomics, so the result is deterministic.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 128;  // columns per CTA, one per thread
constexpr int kMaxB = 8;

__global__ void __launch_bounds__(kCols)
gemv_partial(const float* __restrict__ x, const float* __restrict__ w,
             float* __restrict__ dst, int B, int K, int N, int kc) {
  extern __shared__ float xs[];  // (B, kc): this chunk of every x row
  const int n = blockIdx.x * kCols + threadIdx.x;
  const int k0 = blockIdx.y * kc;
  const int len = min(K, k0 + kc) - k0;
  for (int i = threadIdx.x; i < B * len; i += blockDim.x) {
    const int b = i / len, k = i - b * len;
    xs[b * kc + k] = x[(long long)b * K + k0 + k];
  }
  __syncthreads();
  if (n >= N) return;
  float acc[kMaxB];
#pragma unroll
  for (int b = 0; b < kMaxB; ++b) acc[b] = 0.f;
  const float* wp = w + (long long)k0 * N + n;
#pragma unroll 8
  for (int k = 0; k < len; ++k) {
    const float wv = __ldg(wp + (long long)k * N);
#pragma unroll
    for (int b = 0; b < kMaxB; ++b)
      if (b < B) acc[b] = fmaf(xs[b * kc + k], wv, acc[b]);
  }
  float* o = dst + (long long)blockIdx.y * B * N;
#pragma unroll
  for (int b = 0; b < kMaxB; ++b)
    if (b < B) o[(long long)b * N + n] = acc[b];
}

__global__ void gemv_reduce(const float* __restrict__ partial,
                            float* __restrict__ out, int BN, int ksplit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= BN) return;
  float s = 0.f;
  for (int j = 0; j < ksplit; ++j) s += partial[(long long)j * BN + i];
  out[i] = s;
}

}  // namespace

// x (B, K), w (K, N), out (B, N), partial (ksplit, B, N) scratch (unused
// when ksplit == 1); all float32, contiguous, on the device of `stream`.
extern "C" int gemv_f32(const float* x, const float* w, float* partial,
                        float* out, int B, int K, int N, int kc, int ksplit,
                        cudaStream_t stream) {
  if (B < 1 || B > kMaxB || kc < 1 || ksplit < 1 ||
      (long long)kc * ksplit < K)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kCols - 1) / kCols, ksplit);
  const size_t smem = sizeof(float) * (size_t)B * kc;
  gemv_partial<<<grid, kCols, smem, stream>>>(
      x, w, ksplit == 1 ? out : partial, B, K, N, kc);
  if (ksplit > 1) {
    const int BN = B * N;
    gemv_reduce<<<(BN + 255) / 256, 256, 0, stream>>>(partial, out, BN,
                                                        ksplit);
  }
  return (int)cudaGetLastError();
}

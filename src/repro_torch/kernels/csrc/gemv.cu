// Small-batch GEMV, out (B, N) = x (B, K) @ w (K, N), B <= 8, for Hopper
// (sm_90a), on the CUDA cores: float32 or bfloat16 operands (one dtype),
// widened to float32 at the load, float32 sums, and a float32 or bfloat16
// output rounded once at the end.
//
// Replaces: src/repro/kernels/gemv.py::gemv (pallas_call at gemv.py:59),
// the TPU kernel that streams W once over a (N blocks, K blocks) grid with
// a VMEM-resident f32 accumulator.
//
// Bound on this card: bytes.  Every weight is used B <= 8 times, so the
// kernel does at most 16 FLOP per 4-byte weight it reads -- far below the
// ~20 FLOP/byte at which the H100's float32 rate, not its HBM, would be
// the limit.  The least time is the K * N weight bytes over the HBM
// bandwidth.
//
// Design: W is row-major (K, N); each thread owns one column and each warp
// reads 32 neighbouring columns of one row, so every W load is one
// coalesced 128-byte transaction and W is read exactly once.  The B rows of
// the CTA's K chunk sit in shared memory and each thread keeps B f32 sums
// in registers.  A ResNet head (N = 1000) gives only 8 column blocks for
// 132 SMs, so K is split into chunks of kc rows (the wrapper sizes kc to
// put about two CTAs on every SM): each chunk writes its partial sums to a
// scratch plane, and a second pass adds the planes in a fixed order -- no
// atomics, so the result is deterministic.  The partial planes are
// float32; the output type is written only by the last pass.

#include <cuda_runtime.h>

#include "dtypes.cuh"
#include "split_k.cuh"

namespace {

constexpr int kCols = 128;  // columns per CTA, one per thread
constexpr int kMaxB = 8;

struct gemv_sum;  // names the split-K sum's instances in a profile

// dst is the output (TO) when there is one chunk (LAST), else the chunk's
// float32 partial plane; each instance has one epilogue, as a run-time
// flag made ptxas spill the loop's registers
template <typename TI, typename TO, bool LAST>
__global__ void __launch_bounds__(kCols)
gemv_partial(const TI* __restrict__ x, const TI* __restrict__ w,
             void* __restrict__ dst, int B, int K, int N, int kc) {
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
  const TI* wp = w + (long long)k0 * N + n;
#pragma unroll 8
  for (int k = 0; k < len; ++k) {
    const float wv = widen(__ldg(wp + (long long)k * N));
#pragma unroll
    for (int b = 0; b < kMaxB; ++b)
      if (b < B) acc[b] = fmaf(xs[b * kc + k], wv, acc[b]);
  }
  if constexpr (LAST) {
    TO* o = static_cast<TO*>(dst);
#pragma unroll
    for (int b = 0; b < kMaxB; ++b)
      if (b < B) o[(long long)b * N + n] = narrow<TO>(acc[b]);
  } else {
    float* o = static_cast<float*>(dst) + (long long)blockIdx.y * B * N;
#pragma unroll
    for (int b = 0; b < kMaxB; ++b)
      if (b < B) o[(long long)b * N + n] = acc[b];
  }
}

template <typename TI, typename TO>
int run(const void* x, const void* w, float* partial, void* out, int B,
        int K, int N, int kc, int ksplit, cudaStream_t stream) {
  const dim3 grid((N + kCols - 1) / kCols, ksplit);
  const size_t smem = sizeof(float) * (size_t)B * kc;
  auto kern = ksplit == 1 ? gemv_partial<TI, TO, true>
                          : gemv_partial<TI, TO, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<grid, kCols, smem, stream>>>(
      static_cast<const TI*>(x), static_cast<const TI*>(w),
      ksplit == 1 ? out : static_cast<void*>(partial), B, K, N, kc);
  if (ksplit > 1) {
    launch_split_k_sum<gemv_sum, TO>(partial, nullptr,
                                     static_cast<TO*>(out), N,
                                     (long long)B * N, ksplit, stream);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, K), w (K, N) float32 (in_bf16 = 0) or bfloat16 (in_bf16 = 1), out
// (B, N) float32 or (out_bf16 = 1) bfloat16, partial (ksplit, B, N)
// float32 scratch (unused when ksplit == 1); all contiguous, on the device
// of `stream`.
extern "C" int gemv(const void* x, const void* w, float* partial, void* out,
                    int B, int K, int N, int kc, int ksplit, int in_bf16,
                    int out_bf16, cudaStream_t stream) {
  if (B < 1 || B > kMaxB || kc < 1 || ksplit < 1 ||
      (long long)kc * ksplit < K)
    return (int)cudaErrorInvalidValue;
  return IO_DISPATCH(in_bf16, out_bf16, run, x, w, partial, out, B, K, N,
                     kc, ksplit, stream);
}

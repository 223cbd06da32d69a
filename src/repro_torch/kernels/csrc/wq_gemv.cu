// Weight-only int8 GEMV, out (B, N) = (x (B, K) @ w (K, N)) * scale[col],
// x float32 or bfloat16 with B <= 8, w int8, out float32 or bfloat16
// (rounded once in the epilogue), for Hopper (sm_90a), on the tensor cores.
//
// Replaces: src/repro/kernels/quant_gemm.py::wq_gemv (pallas_call at
// quant_gemm.py:166), the TPU kernel that streams the int8 weight once
// over an (N blocks, K blocks) grid into a VMEM f32 accumulator and applies
// the column scale after the whole K loop.
//
// Bound on this card: bytes, the K * N weight bytes over the HBM bandwidth
// (a Yi-9B decode step streams 8.5 GB through this kernel).  The design,
// shared with int4_gemv.cu, is wq_gemv.cuh's: transposed bf16 mma.sync
// tiles (weight columns x the <= 8 rows of x), weight and x through one
// cp.async ring, each byte decoded to an exact bfloat16, a float32 x as
// three exact bfloat16 terms, and K split over warps and, where the grid
// is narrow, over CTAs in the same launch.

#include "wq_gemv.cuh"

// x (B, K) float32 or (x_bf16) bfloat16, w (K, N) int8, scale (N,) float32,
// out (B, N) float32 or (out_bf16) bfloat16, planes and counters: as
// wq::run says.  args: B, K, N, kc (K rows a CTA), ksplit, vec (the
// weight's copy width in bytes), x_bf16, out_bf16.
extern "C" int wq_gemv(const void* x, const int8_t* w, const float* scale,
                       float* planes, int* counters, void* out,
                       const int* args, cudaStream_t stream) {
  const int B = args[0], K = args[1], N = args[2], kc = args[3];
  const int ksplit = args[4], vec = args[5], x_bf16 = args[6];
  const int out_bf16 = args[7];
  return wq::run<wq::Int8>(x, w, scale, planes, counters, out, B, K, N, kc,
                           ksplit, vec, x_bf16, out_bf16, stream);
}

// the constants the wrapper's planner copies
extern "C" void wq_gemv_tiles(int* t) {
  constexpr int kCols = wq::kCols;
  constexpr int kStageRows = wq::Ring<wq::Int8>::kStageRows;
  constexpr int kThreads = wq::kThreads;
  constexpr int kRingBytes = wq::Ring<wq::Int8>::kBytes;
  t[0] = kCols;
  t[1] = kStageRows;
  t[2] = kThreads;
  t[3] = kRingBytes;
}

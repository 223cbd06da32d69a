// Weight-only int4 GEMV, out (B, N) = (x (B, K) @ w (K, N)) * scale[col],
// x float32 or bfloat16 with B <= 8, w nibble-packed along K (packed
// (ceil(K/2), N) int8, byte (kp, n) = (w[2kp+1][n] << 4) | (w[2kp][n] &
// 0xF)), out float32 or bfloat16 (rounded once in the epilogue), for
// Hopper (sm_90a), on the tensor cores.
//
// Replaces: src/repro/kernels/quant_gemm.py::int4_gemv (pallas_call at
// quant_gemm.py:303), the TPU kernel that streams the packed weight once
// over an (N blocks, K blocks) grid (bk forced even), unpacks each block in
// VMEM into an f32 accumulator and applies the column scale after the whole
// K loop.
//
// Bound on this card: bytes, the K * N / 2 packed bytes over the HBM
// bandwidth (each packed byte feeds 2 B multiply-adds: far below the
// tensor cores' rate, and on the CUDA cores its 16 FMAs and two nibble
// conversions outlast its arrival).  The design is wq_gemv.cuh's, shared
// with wq_gemv.cu, with packed weight rows: one byte's two nibbles are
// the k pair of one bf16x2 A register, decoded exactly with no conversion
// instruction (one PRMT, one LOP3, one bf16x2 FMA a byte); a stage is 128
// k rows, 64 packed byte rows (the int8 stage's bytes), two k16 steps a
// warp, since the loop is issue-bound and a stage's fixed work then weighs
// on twice the k rows; K chunks of a split are whole stages, so they
// start on whole packed rows, and the planes are summed in the same
// launch.  An odd K's last high nibble is the zero pad (its x is zero
// too).

#include "wq_gemv.cuh"

// x (B, K) float32 or (x_bf16) bfloat16, w (ceil(K/2), N) packed int8,
// scale (N,) float32, out (B, N) float32 or (out_bf16) bfloat16, planes
// and counters: as wq::run says.  args: B, K, N, kc (K rows a CTA, even
// where K is split), ksplit, vec (the weight's copy width in bytes),
// x_bf16, out_bf16.
extern "C" int int4_gemv(const void* x, const int8_t* w, const float* scale,
                         float* planes, int* counters, void* out,
                         const int* args, cudaStream_t stream) {
  const int B = args[0], K = args[1], N = args[2], kc = args[3];
  const int ksplit = args[4], vec = args[5], x_bf16 = args[6];
  const int out_bf16 = args[7];
  return wq::run<wq::Int4>(x, w, scale, planes, counters, out, B, K, N, kc,
                           ksplit, vec, x_bf16, out_bf16, stream);
}

// the constants the wrapper's planner copies
extern "C" void int4_gemv_tiles(int* t) {
  constexpr int kCols = wq::kCols;
  constexpr int kStageRows = wq::Ring<wq::Int4>::kStageRows;
  constexpr int kThreads = wq::kThreads;
  constexpr int kRingBytes = wq::Ring<wq::Int4>::kBytes;
  t[0] = kCols;
  t[1] = kStageRows;
  t[2] = kThreads;
  t[3] = kRingBytes;
}

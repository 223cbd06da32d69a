// Weight-only GeMM against a nibble-packed int4 weight, for Hopper
// (sm_90a), on the tensor cores: out (M, N) = (a (M, K) @ w (K, N)) *
// scale[col], a float32 or bfloat16, out float32 or bfloat16, w stored two
// signed nibbles per byte along K: packed (ceil(K/2), N) int8, byte (kp, n)
// = (w[2kp+1][n] << 4) | (w[2kp][n] & 0xF).  An odd K pads its last
// byte's high nibble with 0.
//
// Replaces: src/repro/kernels/quant_gemm.py::int4_gemm (pallas_call at
// quant_gemm.py:244), the TPU kernel with an (M, N, K) grid that unpacks
// each (bk/2, bn) packed block in VMEM (sign-extending shifts, bk forced
// even), multiplies it in the activation dtype into an f32 accumulator and
// applies the column scale once, at the last K step.
//
// Bound on this card: operations at the prefill width (M = 128): each
// packed byte feeds 2 * 2 * 128 FLOP, and a float32 lhs takes three bf16
// products per weight (wo_gemm.cuh), so the bf16 tensor-core rate bounds it
// long before the half byte per weight.
//
// Design: wo_gemm.cuh's weight-only GeMM with Int4Weight's decode -- the
// packed bytes stream through the cp.async ring at half a byte a weight,
// and each stage's pass writes the low and high nibbles of a packed row as
// two bfloat16 K rows (sign-extending shifts; exact).  A 64-deep stage
// starts on a whole packed byte, and so does every K chunk of the split
// (kc a multiple of 64); the f32 partial planes are summed by split_k.cuh,
// which applies scale[col] and rounds to the output type.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "wo_gemm.cuh"

namespace {

struct int4_gemm_tag;  // names this library's kernels in a profile

}  // namespace

// a (M, K) float32 or (a_bf16 = 1) bfloat16, w (ceil(K/2), N) packed int8,
// scale (N,) float32, out (M, N) float32 or (out_bf16 = 1) bfloat16, all
// contiguous; bm (16, 32, 64 or 128) the CTA's rows, K split into ksplit
// chunks of kc rows (kc a multiple of 64 unless ksplit == 1), partial
// (ksplit, M, N) float32 scratch (unused when ksplit == 1), as the
// wrapper's planner gives them.
extern "C" int int4_gemm(const void* a, const int8_t* w, const float* scale,
                         float* partial, void* out, int M, int K, int N,
                         int bm, int kc, int ksplit, int a_bf16, int out_bf16,
                         cudaStream_t stream) {
  return run_wo<int4_gemm_tag, Int4Weight>(
      a, reinterpret_cast<const uint8_t*>(w), scale, partial, out, M, K, N,
      bm, kc, ksplit, a_bf16, out_bf16, stream);
}

// The constants the wrapper's planner (quant_gemm.py: tc_split_k) sizes
// its grid by, for it to check once at load: tile columns, stage depth.
extern "C" void int4_gemm_tiles(int* t) {
  t[0] = kBN;
  t[1] = kBK;
}

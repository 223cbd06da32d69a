// Quantized GeMM with a fused dequantize epilogue, for Hopper (sm_90a), on
// the tensor cores: out (M, N) = (a (M, K) @ b (K, N)) * scale[col], b int8
// with N contiguous, out float32 or bfloat16, and a either
//   int8    (int32 sums, exact; the calibrated int8 path), or
//   float   (weight-only, float32 or bfloat16: wo_gemm.cuh, f32 sums).
//
// Replaces: src/repro/kernels/quant_gemm.py::quant_gemm (pallas_call at
// quant_gemm.py:106), the TPU kernel with an (M, N, K) grid, a VMEM
// accumulator and the epilogue acc.astype(f32) * scale at the last K step.
//
// Bound on this card: bytes at the shapes the models send it.  Each int8
// weight byte feeds 2 * M operations -- 256 at the LM's prefill width (M =
// 128), 16 at decode (M = 8), 64 at the vision heads (M = 32) -- against
// the int8 tensor cores' ~590 per HBM byte.  So the design streams the
// weight at HBM rate with enough CTAs in flight, as fp8_gemm.cu does.
//
// Design of the int8 x int8 path (mma.cuh's tile, stage ring and
// epilogue):
//   * Products on mma.sync.m16n8k32 s8 x s8 -> s32: exact, so the kernel
//     equals the reference bit for bit.  The lhs stage is row-major int8,
//     whose 16-byte rows ldmatrix (b16) reads as the s8 A fragment
//     directly.  The weight is N-major, but the s8 B fragment wants four
//     neighbouring k of one column in each register, and ldmatrix.trans
//     moves 16-bit elements only; so after a stage lands a pass transposes
//     its bytes in 4 x 4 blocks (__byte_perm) into a K-major tile, which
//     ldmatrix reads as the B fragments.  The pass's reads (the stage's
//     16-byte chunks are swizzled by row) and writes (each thread rotates
//     the rows it writes) hit 32 distinct banks.
//   * A ring of kStages (4) stages filled with 16-byte cp.async,
//     zero-filled past the edges: M = 8 pads to the mma's 16 rows at no
//     HBM cost.  BM is 16, 32, 64 or 128, the smallest that covers M.
//   * Split-K until about two CTAs sit on each SM (the wrapper's planner,
//     tc_split_k).  The partial planes are int32: |acc| passes 2^24 (127^2
//     * 11008 ~ 1.8e8 at Yi-9B's down projection), where f32 planes would
//     round.  split_k.cuh sums them in int32, casts once to float32 and
//     multiplies by scale[col], the reference's epilogue; one chunk does
//     the same in the GeMM's own epilogue.
//   Ragged K or N (the vision heads' N = 1000), or an operand not 16-byte
//   aligned, take the same pipeline with byte loads (synchronous).

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "dtypes.cuh"
#include "mma.cuh"
#include "split_k.cuh"
#include "wo_gemm.cuh"

namespace {

struct qgemm_tag;  // names this library's kernels in a profile

constexpr int kStages = 4;
constexpr int kAS8 = kBK + 16;   // byte row stride of the lhs stage (80 B)
constexpr int kBT = kBK + 16;    // byte row stride of the K-major B tile

template <int BM>
struct Q8 : WarpTiles<BM> {
  static constexpr int kStageBytes = BM * kAS8 + kBK * kBN;
  static constexpr int kSmem = kStages * kStageBytes + kBN * kBT;
};

// one stage: a[m0 : m0+BM, k0 : k0+kBK] and b[k0 : k0+kBK, n0 : n0+kBN],
// zero past M, N and kend.  VEC: 16-byte cp.async (K, N and kend are
// multiples of 16, so each 16-byte piece is wholly inside or outside).
template <int BM, bool VEC>
__device__ __forceinline__ void load_s8(uint8_t* a8, uint8_t* b8,
                                        const uint8_t* __restrict__ a,
                                        const uint8_t* __restrict__ b, int M,
                                        int K, int N, int m0, int n0, int k0,
                                        int kend) {
  for (int c = threadIdx.x; c < BM * (kBK / 16); c += kTcThreads) {
    const int r = c / (kBK / 16), q = c % (kBK / 16);
    const int m = m0 + r, k = k0 + 16 * q;
    uint8_t* dst = a8 + r * kAS8 + 16 * q;
    if (VEC) {
      const bool ok = m < M && k < kend;
      cp_async16(dst, ok ? a + (long long)m * K + k : a, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        dst[j] = (m < M && k + j < kend) ? a[(long long)m * K + k + j] : 0;
    }
  }
  for (int c = threadIdx.x; c < kBK * (kBN / 16); c += kTcThreads) {
    const int r = c / (kBN / 16), q = c % (kBN / 16);
    const int k = k0 + r, n = n0 + 16 * q;
    uint8_t* dst = b8 + r * kBN + 16 * s8_chunk<kBN>(r, q);
    if (VEC) {
      const bool ok = k < kend && n < N;
      cp_async16(dst, ok ? b + (long long)k * N + n : b, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        dst[j] = (k < kend && n + j < N) ? b[(long long)k * N + n + j] : 0;
    }
  }
}

// grid (ceil(N / kBN), ceil(M / BM), ksplit); chunk z covers K rows
// [z * kc, min(K, (z + 1) * kc)).  dst: the output (TO, scaled) when
// ksplit == 1, else the int32 partial planes (ksplit, M, N).
template <int BM, bool VEC, typename TO>
__global__ void __launch_bounds__(kTcThreads)
qgemm_tc(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
         const float* __restrict__ scale, void* __restrict__ dst, int M,
         int K, int N, int kc) {
  using C = Q8<BM>;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* bt = smem + kStages * C::kStageBytes;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int k0 = blockIdx.z * kc, kend = min(K, k0 + kc);
  const int nt = (kend - k0 + kBK - 1) / kBK;

  int acc[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  auto stage_a = [&](int s) { return smem + s * C::kStageBytes; };
  auto stage_b = [&](int s) {
    return smem + s * C::kStageBytes + BM * kAS8;
  };
  auto load = [&](int s, int t) {
    load_s8<BM, VEC>(stage_a(s), stage_b(s), a, b, M, K, N, m0, n0,
                     k0 + t * kBK, kend);
  };
  auto compute = [&](int s) {
    transpose_s8<kBK, kBN, kBT>(stage_b(s), bt);
    __syncthreads();
    const uint8_t* a8 = stage_a(s);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      unsigned af[C::MT][4];
#pragma unroll
      for (int i = 0; i < C::MT; ++i) {
        const int row = wm * C::WTM + 16 * i + lane % 16;
        ldsm_x4(af[i], a8 + row * kAS8 + kk + 16 * (lane / 16));
      }
      unsigned bf[C::NT][2];
#pragma unroll
      for (int j = 0; j < C::NT; j += 2) {
        const int n = wn * C::WTN + 8 * j + lane % 8 + 8 * (lane / 16);
        unsigned r[4];
        ldsm_x4(r, bt + n * kBT + kk + 16 * ((lane / 8) % 2));
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < C::MT; ++i)
#pragma unroll
        for (int j = 0; j < C::NT; ++j)
          mma16832_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  };
  stage_ring<kStages>(nt, load, compute);
  store_acc<TO>(acc, scale, dst, M, N, m0 + wm * C::WTM, n0 + wn * C::WTN);
}

template <int BM, bool VEC, typename TO>
int launch_s8(const uint8_t* a, const uint8_t* b, const float* scale,
              int* partial, void* out, int M, int K, int N, int kc,
              int ksplit, cudaStream_t stream) {
  constexpr int smem = Q8<BM>::kSmem;
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        qgemm_tc<BM, VEC, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, ksplit);
  qgemm_tc<BM, VEC, TO><<<grid, kTcThreads, smem, stream>>>(
      a, b, scale, ksplit == 1 ? out : static_cast<void*>(partial), M, K, N,
      kc);
  if (ksplit > 1)
    launch_split_k_sum<qgemm_tag, TO>(partial, scale, static_cast<TO*>(out),
                                      N, (long long)M * N, ksplit, stream);
  return (int)cudaGetLastError();
}

template <typename TO>
int run_s8(const uint8_t* a, const uint8_t* b, const float* scale,
           int* partial, void* out, int M, int K, int N, int bm, int kc,
           int ksplit, cudaStream_t stream) {
  const bool vec = K % 16 == 0 && N % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  return with_bm(bm, [&](auto BM) {
    constexpr int bm_ = decltype(BM)::value;
    return vec ? launch_s8<bm_, true, TO>(a, b, scale, partial, out, M, K,
                                          N, kc, ksplit, stream)
               : launch_s8<bm_, false, TO>(a, b, scale, partial, out, M, K,
                                           N, kc, ksplit, stream);
  });
}

}  // namespace

// b (K, N) int8, scale (N,) float32, out (M, N) float32 or (out_bf16 = 1)
// bfloat16, all contiguous; bm (16, 32, 64 or 128) the CTA's rows, K split
// into ksplit chunks of kc rows (kc a multiple of 64 unless ksplit == 1),
// as the wrapper's planner gives them.
//   a_kind 2: a (M, K) int8, partial (ksplit, M, N) int32 scratch;
//   a_kind 0 / 1: a (M, K) float32 / bfloat16 (weight-only), partial
//     (ksplit, M, N) float32 scratch.
// partial is unused when ksplit == 1.
extern "C" int quant_gemm(const void* a, const int8_t* b, const float* scale,
                          void* partial, void* out, int M, int K, int N,
                          int bm, int kc, int ksplit, int a_kind,
                          int out_bf16, cudaStream_t stream) {
  const uint8_t* b8 = reinterpret_cast<const uint8_t*>(b);
  if (a_kind == 0 || a_kind == 1)
    return run_wo<qgemm_tag, Int8Weight>(
        a, b8, scale, static_cast<float*>(partial), out, M, K, N, bm, kc,
        ksplit, a_kind, out_bf16, stream);
  if (a_kind != 2 || !tc_grid_ok(M, K, N, bm, kc, ksplit))
    return (int)cudaErrorInvalidValue;
  const uint8_t* a8 = static_cast<const uint8_t*>(a);
  int* p = static_cast<int*>(partial);
  return out_bf16 ? run_s8<bf16>(a8, b8, scale, p, out, M, K, N, bm, kc,
                                 ksplit, stream)
                  : run_s8<float>(a8, b8, scale, p, out, M, K, N, bm, kc,
                                  ksplit, stream);
}

// The constants the wrapper's planner (quant_gemm.py: tc_split_k) sizes
// its grid by, for it to check once at load: tile columns, stage depth.
extern "C" void quant_gemm_tiles(int* t) {
  t[0] = kBN;
  t[1] = kBK;
}

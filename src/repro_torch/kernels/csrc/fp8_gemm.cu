// e4m3 GeMM with a column-scale epilogue, for Hopper (sm_90a):
// out (M, N) = (a (M, K) @ b (K, N)) * scale[col], b e4m3 (float8_e4m3fn)
// with N contiguous, a e4m3 or float (float32 / bfloat16: the weight-only
// form), out float32 or bfloat16, f32 accumulation.
//
// Replaces: src/repro/kernels/quant_gemm.py::fp8_gemm (pallas_call at
// quant_gemm.py:367), the TPU kernel with an (M, N, K) grid that casts
// both blocks to f32 in VMEM, accumulates in an f32 scratch and applies
// acc * scale at the last K step.
//
// Bound on this card: bytes at the shapes the LM sends it.  Each K x N
// weight byte is read once and feeds 2 * M FLOP: 256 at the prefill width
// (M = 128) against fp16's ~295 FLOP per HBM byte, 16 at decode (M = 8).
// So the design's aim is to stream the weight at HBM rate with enough CTAs
// in flight, while the products keep up.
//
// Design of the e4m3 x e4m3 path (the one every model call takes):
//   * Tensor cores on exact products.  Each e4m3 tile is decoded to fp16
//     in shared memory (cvt.rn.f16x2.e4m3x2: every e4m3 value is an fp16
//     value, so the decode is exact) and multiplied with
//     mma.sync.m16n8k16 f16 x f16 -> f32.  An fp16 x fp16 product is exact,
//     so the function stays the reference's f32 sum of exact products, up
//     to summation order; the tensor core's own f32 sums hold the plain
//     version within chip_smoke.py's 1e-4 of max|out| at every Yi-9B shape
//     up to K = 11008, so there is no separate promotion into an f32
//     accumulator.  Not FP8 tensor-core products: those accumulate at
//     reduced precision (arXiv:2412.19437), and take K-major operands
//     only, where the weight is N-major; ldmatrix.trans reads the fp16
//     tile as the B fragment instead.  mma.sync and not wgmma: mma.sync's
//     fragments need no shared-memory descriptors, and its rate is far
//     above what the kernel reaches -- the kernel runs several times over
//     both its bytes bound and its fp16 product time, so neither the HBM
//     nor the tensor cores set its time; what does is not measured yet
//     (ROADMAP.md).  No wgmma form of this kernel has been shown correct.
//   * Asynchronous copies.  A ring of kStages (4) one-byte stages in
//     shared memory, filled with 16-byte cp.async (zero-filled past the
//     edges), so the loads of stage t + 3 overlap the decode and products
//     of stage t.  HBM bytes stay one per element; only the shared-memory
//     staging tile holds fp16.
//   * Split-K.  The grid is (N tiles of 128, M tiles of BM, K chunks): the
//     wrapper splits K (chunks of whole 64-deep steps) until about two CTAs
//     sit on each SM, while the f32 partial planes stay within eight
//     times the weight's bytes.  Each chunk writes its own f32 partial
//     plane to a scratch the wrapper allocates; a second kernel
//     (split_k.cuh) sums the planes in chunk order, applies scale[col] and
//     rounds to the output type (no atomics: the result is
//     deterministic).  One chunk writes the output directly.
//   * One kernel for both widths: BM is 16, 32, 64 or 128 rows, the
//     smallest that covers M (a larger M takes several 128-row tiles); at
//     M = 8 the token rows are padded to the 16 rows of the mma with
//     zero-filled loads, which costs products but no HBM bytes.
//   Ragged K or N, or an operand not 16-byte aligned, take the same
//   pipeline with byte loads (synchronous) instead of cp.async.
//   The CTA tile, the ldmatrix / mma.sync helpers, the stage ring and the
//   epilogue are mma.cuh's, shared with quant_gemm.cu and int4_gemm.cu.
//
// The weight-only form (float32 or bfloat16 lhs), which no model path
// takes, stays on the CUDA-core OS tile: each e4m3 byte decoded to float32
// as it is stored in shared memory, a bfloat16 lhs widened, fmaf sums.

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "dtypes.cuh"
#include "mma.cuh"
#include "split_k.cuh"

namespace {

struct fp8_gemm_sum;  // names the split-K sum's instances in a profile

// ---------------------------------------------------------------------------
// e4m3 x e4m3 on the tensor cores (the CTA tile and kBK: mma.cuh)
// ---------------------------------------------------------------------------

constexpr int kStages = 4;
constexpr int kAS = kBK + 8;      // fp16 row stride of the A tile (144 B)
constexpr int kBS = kBN + 8;      // fp16 row stride of the B tile (272 B)

template <int BM>
struct Tc : WarpTiles<BM> {
  static constexpr int kStageBytes = BM * kBK + kBK * kBN;
  static constexpr int kSmem =
      kStages * kStageBytes + 2 * (BM * kAS + kBK * kBS);
};

// two e4m3 bytes (the low one first) -> their fp16 pair, exactly
__device__ __forceinline__ unsigned e4m3x2_f16x2(unsigned pair) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(pair & 0xFFFFu), __NV_E4M3);
  return (unsigned)h.x | ((unsigned)h.y << 16);
}

// 16 e4m3 bytes at src -> 16 fp16 values at dst (both 16-byte aligned)
__device__ __forceinline__ void decode16(const uint8_t* src, uint16_t* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  unsigned h[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[2 * i] = e4m3x2_f16x2(w[i]);
    h[2 * i + 1] = e4m3x2_f16x2(w[i] >> 16);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(dst + 8) = make_uint4(h[4], h[5], h[6], h[7]);
}

// one stage: a[m0 : m0+BM, k0 : k0+kBK] and b[k0 : k0+kBK, n0 : n0+kBN],
// zero past M, N and kend.  VEC: 16-byte cp.async (K, N and kend are
// multiples of 16, so each 16-byte piece is wholly inside or outside).
template <int BM, bool VEC>
__device__ __forceinline__ void load_stage(uint8_t* a8, uint8_t* b8,
                                           const uint8_t* __restrict__ a,
                                           const uint8_t* __restrict__ b,
                                           int M, int K, int N, int m0,
                                           int n0, int k0, int kend) {
  for (int c = threadIdx.x; c < BM * (kBK / 16); c += kTcThreads) {
    const int r = c / (kBK / 16), q = c % (kBK / 16);
    const int m = m0 + r, k = k0 + 16 * q;
    uint8_t* dst = a8 + r * kBK + 16 * q;
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
    uint8_t* dst = b8 + r * kBN + 16 * q;
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
// ksplit == 1, else the float32 partial planes (ksplit, M, N).
template <int BM, bool VEC, typename TO>
__global__ void __launch_bounds__(kTcThreads)
fp8_tc(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
       const float* __restrict__ scale, void* __restrict__ dst, int M, int K,
       int N, int kc) {
  using C = Tc<BM>;
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* A16 = reinterpret_cast<uint16_t*>(smem + kStages * C::kStageBytes);
  uint16_t* B16 = A16 + BM * kAS;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int k0 = blockIdx.z * kc, kend = min(K, k0 + kc);
  const int nt = (kend - k0 + kBK - 1) / kBK;

  float acc[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto stage_a = [&](int s) { return smem + s * C::kStageBytes; };
  auto stage_b = [&](int s) { return smem + s * C::kStageBytes + BM * kBK; };
  auto load = [&](int s, int t) {
    load_stage<BM, VEC>(stage_a(s), stage_b(s), a, b, M, K, N, m0, n0,
                        k0 + t * kBK, kend);
  };
  auto compute = [&](int s) {
    const uint8_t* a8 = stage_a(s);
    const uint8_t* b8 = stage_b(s);
    for (int c = tid; c < BM * (kBK / 16); c += kTcThreads) {
      const int r = c / (kBK / 16), q = c % (kBK / 16);
      decode16(a8 + r * kBK + 16 * q, A16 + r * kAS + 16 * q);
    }
    for (int c = tid; c < kBK * (kBN / 16); c += kTcThreads) {
      const int r = c / (kBN / 16), q = c % (kBN / 16);
      decode16(b8 + r * kBN + 16 * q, B16 + r * kBS + 16 * q);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      unsigned af[C::MT][4];
#pragma unroll
      for (int i = 0; i < C::MT; ++i) {
        const int row = wm * C::WTM + 16 * i + lane % 16;
        ldsm_x4(af[i], A16 + row * kAS + kk + 8 * (lane / 16));
      }
      unsigned bf[C::NT][2];
#pragma unroll
      for (int j = 0; j < C::NT; j += 2) {
        const int row = kk + lane % 8 + 8 * ((lane / 8) % 2);
        const int col = wn * C::WTN + 8 * j + 8 * (lane / 16);
        unsigned r[4];
        ldsm_x4_t(r, B16 + row * kBS + col);
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < C::MT; ++i)
#pragma unroll
        for (int j = 0; j < C::NT; ++j)
          mma16816(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  };
  stage_ring<kStages>(nt, load, compute);
  store_acc<TO>(acc, scale, dst, M, N, m0 + wm * C::WTM, n0 + wn * C::WTN);
}

template <int BM, bool VEC, typename TO>
int launch_tc(const uint8_t* a, const uint8_t* b, const float* scale,
              float* partial, void* out, int M, int K, int N, int kc,
              int ksplit, cudaStream_t stream) {
  constexpr int smem = Tc<BM>::kSmem;
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        fp8_tc<BM, VEC, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, ksplit);
  fp8_tc<BM, VEC, TO><<<grid, kTcThreads, smem, stream>>>(
      a, b, scale, ksplit == 1 ? out : static_cast<void*>(partial), M, K, N,
      kc);
  if (ksplit > 1) {
    const long long MN = (long long)M * N;
    launch_split_k_sum<fp8_gemm_sum, TO>(partial, scale,
                                         static_cast<TO*>(out), N, MN,
                                         ksplit, stream);
  }
  return (int)cudaGetLastError();
}

template <bool VEC, typename TO>
int run_tc(const uint8_t* a, const uint8_t* b, const float* scale,
           float* partial, void* out, int M, int K, int N, int bm, int kc,
           int ksplit, cudaStream_t stream) {
  return with_bm(bm, [&](auto BM) {
    return launch_tc<decltype(BM)::value, VEC, TO>(a, b, scale, partial, out,
                                                   M, K, N, kc, ksplit,
                                                   stream);
  });
}

// ---------------------------------------------------------------------------
// the weight-only form: float lhs, CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // 16 x 16
constexpr int kStep = 16;      // K depth of one shared-memory step

__device__ __forceinline__ float e4m3(uint8_t byte) {
  __nv_fp8_e4m3 v;
  v.__x = byte;
  return static_cast<float>(v);
}

template <int BM, int BN, typename TA, typename TO>
__global__ void __launch_bounds__(kThreads)
fp8_gemm_tile(const TA* __restrict__ a, const uint8_t* __restrict__ b,
              const float* __restrict__ scale, TO* __restrict__ out,
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
      As[c][r] = (m < M && k < K) ? widen(a[(long long)m * K + k]) : 0.f;
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
      if (n < N)
        out[(long long)m * N + n] =
            narrow<TO>(__fmul_rn(acc[r][c], scale[n]));
    }
  }
}

template <typename TA, typename TO>
int run_float(const void* a, const uint8_t* b, const float* scale, void* out,
              int M, int K, int N, int bm, int bn, cudaStream_t stream) {
#define FP8_TILE(BM_, BN_)                                                 \
  if (bm == BM_ && bn == BN_) {                                            \
    const int nm = (M + BM_ - 1) / BM_, nn = (N + BN_ - 1) / BN_;          \
    fp8_gemm_tile<BM_, BN_, TA, TO><<<nm * nn, kThreads, 0, stream>>>(     \
        static_cast<const TA*>(a), b, scale, static_cast<TO*>(out), M, K,  \
        N, nn);                                                            \
    return (int)cudaGetLastError();                                        \
  }
  FP8_TILE(32, 32) FP8_TILE(32, 64) FP8_TILE(32, 128)
  FP8_TILE(64, 32) FP8_TILE(64, 64) FP8_TILE(64, 128)
  FP8_TILE(128, 32) FP8_TILE(128, 64) FP8_TILE(128, 128)
#undef FP8_TILE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// b (K, N) e4m3 bytes, scale (N,) float32, out (M, N) float32 or
// (out_bf16 = 1) bfloat16, all contiguous.
//   a_kind 2: a (M, K) e4m3 bytes, the tensor-core kernel: bm (16, 32, 64
//     or 128) the CTA's rows, K split into ksplit chunks of kc rows (kc a
//     multiple of 64 unless ksplit == 1), partial (ksplit, M, N) float32
//     scratch (unused when ksplit == 1); bn unused.
//   a_kind 0 / 1: a (M, K) float32 / bfloat16, the CUDA-core tile (bm, bn)
//     each of 32, 64 or 128; kc, ksplit and partial unused.
extern "C" int fp8_gemm(const void* a, const uint8_t* b, const float* scale,
                        float* partial, void* out, int M, int K, int N,
                        int bm, int bn, int kc, int ksplit, int a_kind,
                        int out_bf16, cudaStream_t stream) {
  if (M < 1 || K < 1 || N < 1 || a_kind < 0 || a_kind > 2)
    return (int)cudaErrorInvalidValue;
  if (a_kind == 2) {
    if (!tc_grid_ok(M, K, N, bm, kc, ksplit))
      return (int)cudaErrorInvalidValue;
    const uint8_t* a8 = static_cast<const uint8_t*>(a);
    const bool vec = K % 16 == 0 && N % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(a8) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(b) % 16 == 0;
    if (vec)
      return out_bf16 ? run_tc<true, bf16>(a8, b, scale, partial, out, M, K,
                                           N, bm, kc, ksplit, stream)
                      : run_tc<true, float>(a8, b, scale, partial, out, M, K,
                                            N, bm, kc, ksplit, stream);
    return out_bf16 ? run_tc<false, bf16>(a8, b, scale, partial, out, M, K,
                                          N, bm, kc, ksplit, stream)
                    : run_tc<false, float>(a8, b, scale, partial, out, M, K,
                                           N, bm, kc, ksplit, stream);
  }
  return IO_DISPATCH(a_kind == 1, out_bf16, run_float, a, b, scale, out, M,
                     K, N, bm, bn, stream);
}

// The constants the wrapper's planner (quant_gemm.py: tc_split_k) sizes
// its grid by, for it to check once at load: tile columns, stage depth.
extern "C" void fp8_gemm_tiles(int* t) {
  t[0] = kBN;
  t[1] = kBK;
}

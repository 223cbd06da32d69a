// Weight-only int8 GEMV, out (B, N) = (x (B, K) @ w (K, N)) * scale[col],
// x float32 or bfloat16 with B <= 8, w int8, out float32 or bfloat16
// (rounded once in the epilogue), for Hopper (sm_90a), on the tensor cores.
//
// Replaces: src/repro/kernels/quant_gemm.py::wq_gemv (pallas_call at
// quant_gemm.py:166), the TPU kernel that streams the int8 weight once
// over an (N blocks, K blocks) grid into a VMEM f32 accumulator and applies
// the column scale after the whole K loop.
//
// Bound on this card: bytes.  Each one-byte weight is used B <= 8 times, so
// the least time is the K * N weight bytes over the HBM bandwidth (a Yi-9B
// decode step streams 8.5 GB through this kernel).  On the CUDA cores the B
// float multiply-adds a byte, and the byte's conversion, cost more issue
// slots than the byte takes to arrive; so the products run on the tensor
// cores, and what is left a byte is its conversion.
//
// Design.  The product is computed transposed, out^T (N, B) = w^T (N, K) @
// x^T (K, B), as mma.sync.m16n8k16 bf16 tiles with f32 accumulators: 16
// weight columns are the tile's rows, the (up to) 8 rows of x its columns.
//   * A CTA of 128 threads owns kCols = 128 weight columns and walks its K
//     chunk in stages of kStageRows = 64 rows.  Each stage -- its weight
//     rows (16-byte cp.async copies; 8-, 4- or 1-byte where N, or the
//     weight's address, is not a multiple of 16) and its 64 values of each
//     row of x (4-byte copies) -- streams through a ring of kStages shared-
//     memory buffers, kStages - 1 of them in flight while one is consumed,
//     so neither the copies in flight nor a long K chunk costs registers or
//     more shared memory.  Rows past the chunk, and rows of x past B, are
//     zero-filled.
//   * Each warp takes one 16-row k step of every stage and all 128 columns
//     as 8 m16 tiles: K is split over the warps.  A lane reads 16 bytes
//     (16 columns) of each of its four k rows, and its tile columns are
//     mapped so that those 16 bytes are exactly the A-fragment bytes it
//     needs.  An int8 byte v becomes an exact bfloat16 without a
//     conversion instruction: placed into the mantissa of 2^23 offset by
//     128 (PRMT), less 2^23 + 128 (exact), its float's high half is v.
//   * x's values are split in registers into three bfloat16 terms whose
//     sum is the float32 value (f32_terms.cuh, split3), so three mma per
//     tile give the float32 product, each term product exact (a bfloat16
//     x is one term, and three products with two of them zero).
//   * After the K loop the 4 warps' accumulators are summed in shared
//     memory in a fixed order and, with one K chunk, multiplied by the
//     column scale and stored.  Where one column block has too few rows
//     to keep the card busy, K is split over ksplit CTAs (quant_gemm.wq_plan
//     sizes it): each writes its partial sums to a float32 plane, and the
//     last CTA of a column block to arrive -- a __threadfence and a
//     counter per column block, which that CTA sets back to zero -- sums
//     the planes in plane order (four planes' loads in flight at a time),
//     so the result does not depend on which CTA came last and no atomic
//     touches the output.  The column scale is applied once, after the
//     whole K sum, as the reference applies it after its whole K loop.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "dtypes.cuh"
#include "f32_terms.cuh"

namespace {

constexpr int kThreads = 256;                // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kWarpsN = 2;                   // warps side by side along N
constexpr int kWarpsK = kWarps / kWarpsN;    // warps splitting K
constexpr int kCols = 128;                   // weight columns per CTA
constexpr int kWarpCols = kCols / kWarpsN;   // a warp's columns
constexpr int kLaneBytes = kWarpCols / 8;    // bytes of a k row a lane reads
constexpr int kTiles = kWarpCols / 16;       // m16 tiles a warp
constexpr int kStageRows = 16 * kWarpsK;     // k rows a stage: a k16 a warp
static_assert(kLaneBytes == 8 || kLaneBytes == 16,
              "a lane's A fragments are one 8- or 16-byte load a row");

// kLaneBytes bytes of one k row, as words xor 0x80808080 (each byte v + 128)
__device__ __forceinline__ void row_words(const int8_t* p,
                                          unsigned (&wd)[kLaneBytes / 4]) {
  constexpr unsigned m = 0x80808080u;
  if constexpr (kLaneBytes == 16) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    wd[0] = q.x ^ m, wd[1] = q.y ^ m, wd[2] = q.z ^ m, wd[3] = q.w ^ m;
  } else {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    wd[0] = q.x ^ m, wd[1] = q.y ^ m;
  }
}
constexpr int kMaxB = 8;                     // the mma's n8
constexpr int kXLd = kStageRows + 8;         // x floats a row of a stage
constexpr int kStageBytes = kStageRows * kCols + kMaxB * kXLd * 4;
constexpr int kStages = 4;                   // ring buffers
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kCtasPerSm = 3;                // the register budget's CTAs

// One thread's copies of stage rows [0, nrows), K index k of row 0: the
// weight's kCols columns from col0 (pieces tid, tid + kThreads, ... of V
// bytes, row-major; wsrc points at the stage's first row), and kStageRows
// values of each of x's kMaxB rows.  Columns past N, rows past nrows and
// x rows past B are zero-filled (from w and x themselves, which are then
// not read).  V: the weight's copy width, dividing N and its address.
template <int V>
__device__ __forceinline__ void load_stage(int8_t* dst, const int8_t* wsrc,
                                           const int8_t* w, const void* x,
                                           int x_bf16, long long k, int B,
                                           int K, long long N, int nrows,
                                           int col0, int tid) {
  constexpr int kPerRow = kCols / V;
#pragma unroll
  for (int i = 0; i < kStageRows * kPerRow / kThreads; ++i) {
    const int p = tid + i * kThreads, r = p / kPerRow, c = p % kPerRow * V;
    const bool ok = r < nrows && col0 + c < N;
    int8_t* d = dst + r * kCols + c;
    const int8_t* sp = ok ? wsrc + r * N + c : w;
    if constexpr (V == 16)
      cp_async16(d, sp, ok ? 16 : 0);
    else if constexpr (V == 8 || V == 4)
      cp_async_ca<V>(d, sp, ok ? V : 0);
    else
      *d = ok ? *sp : 0;
  }
  float* xd = reinterpret_cast<float*>(dst + kStageRows * kCols);
#pragma unroll
  for (int i = 0; i < kMaxB * kStageRows / kThreads; ++i) {
    const int e = tid + i * kThreads, b = e / kStageRows, r = e % kStageRows;
    const bool ok = b < B && r < nrows;
    const long long at = (long long)b * K + k + r;
    if (x_bf16)
      xd[b * kXLd + r] = ok ? widen(static_cast<const bf16*>(x)[at]) : 0.f;
    else
      cp_async_ca<4>(xd + b * kXLd + r,
                     static_cast<const float*>(x) + (ok ? at : 0),
                     ok ? 4 : 0);
  }
}

// the bfloat16 pair {v(byte p of lo), v(byte p of hi)} of two words whose
// bytes are each int8 v + 128: 2^23 + (v + 128) less 2^23 + 128 is v,
// exactly, and a float with at most 8 significant bits is its high half
__device__ __forceinline__ unsigned int8_pair(unsigned lo, unsigned hi,
                                              int p) {
  const float a =
      __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7540 | p)) - 8388736.f;
  const float b =
      __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7540 | p)) - 8388736.f;
  return hi_halves(__float_as_uint(a), __float_as_uint(b));
}

// the three bf16x2 terms of the float pair (a at the lower k)
__device__ __forceinline__ void split_pair_exact(float a, float b,
                                                 unsigned (&t)[3]) {
  unsigned ta[3], tb[3];
  split3(a, ta);
  split3(b, tb);
#pragma unroll
  for (int e = 0; e < 3; ++e) t[e] = hi_halves(ta[e], tb[e]);
}

__device__ __forceinline__ void store_out(void* out, int out_bf16,
                                          long long i, float v) {
  if (out_bf16)
    static_cast<bf16*>(out)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(out)[i] = v;
}

template <int V>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
wq_gemv_mma(const void* __restrict__ x, int x_bf16,
            const int8_t* __restrict__ w, const float* __restrict__ scale,
            float* __restrict__ planes, int* __restrict__ counters,
            void* __restrict__ out, int out_bf16, int B, int K, int N,
            int kc, int ksplit) {
  extern __shared__ float4 smem4[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem4);   // kStages stages
  int* last = reinterpret_cast<int*>(ring + kRingBytes);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wn = warp % kWarpsN, wk = warp / kWarpsN;
  const int cx = blockIdx.x, cy = blockIdx.y;
  const int k0 = cy * kc, len = min(K, k0 + kc) - k0;
  const int col0 = cx * kCols;
  const int stages = (len + kStageRows - 1) / kStageRows;
  const int8_t* src = w + (long long)k0 * N + col0;
  const long long stage_step = (long long)kStageRows * N;
  auto load = [&](int s) {
    load_stage<V>(ring + (s % kStages) * kStageBytes, src + s * stage_step,
                  w, x, x_bf16, k0 + (long long)s * kStageRows, B, K, N,
                  len - s * kStageRows, col0, tid);
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < stages) load(s);
    cp_async_commit();
  }
  float acc[kTiles][4];
#pragma unroll
  for (int j = 0; j < kTiles; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<kStages - 2>();  // stage s has landed
    __syncthreads();               // ... for every thread; stage s - 1 is free
    if (s + kStages - 1 < stages) load(s + kStages - 1);
    cp_async_commit();
    // this warp's k16 step, k rows kk + 2t, + 1, + 8, + 9 of the stage,
    // and its kWarpCols columns
    const int kk = wk * 16;
    const int8_t* st = ring + (s % kStages) * kStageBytes;
    const int8_t* wr =
        st + (kk + 2 * t) * kCols + wn * kWarpCols + g * kLaneBytes;
    unsigned w0[kLaneBytes / 4], w1[kLaneBytes / 4];
    unsigned w8[kLaneBytes / 4], w9[kLaneBytes / 4];
    row_words(wr, w0);
    row_words(wr + kCols, w1);
    row_words(wr + 8 * kCols, w8);
    row_words(wr + 9 * kCols, w9);
    // x^T's B fragments: row g of x, k rows 2t, 2t + 1 (b0), + 8 (b1)
    const float* xr = reinterpret_cast<const float*>(st + kStageRows * kCols) +
                      g * kXLd + kk + 2 * t;
    const float2 x0 = *reinterpret_cast<const float2*>(xr);
    const float2 x8 = *reinterpret_cast<const float2*>(xr + 8);
    unsigned b0[3], b1[3];
    split_pair_exact(x0.x, x0.y, b0);
    split_pair_exact(x8.x, x8.y, b1);
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      // tile j's rows g and g + 8 are this lane's columns 2j and 2j + 1
      const int wd = j / 2, p = 2 * (j % 2);
      const unsigned a[4] = {int8_pair(w0[wd], w1[wd], p),
                             int8_pair(w0[wd], w1[wd], p + 1),
                             int8_pair(w8[wd], w9[wd], p),
                             int8_pair(w8[wd], w9[wd], p + 1)};
#pragma unroll
      for (int e = 0; e < 3; ++e) mma16816_bf16(acc[j], a, b0[e], b1[e]);
    }
  }

  // the K warps' sums, in order; (wk, wn, tile, reg, lane) in the ring
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);
  constexpr int kWarpVals = kTiles * 4 * 32;
#pragma unroll
  for (int j = 0; j < kTiles; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      red[warp * kWarpVals + (j * 4 + i) * 32 + lane] = acc[j][i];
  __syncthreads();
  constexpr int kPer = kWarpsN * kWarpVals / kThreads;
  float v[kPer];
  int bo[kPer], co[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int o = tid + e * kThreads;   // (wn, tile, reg, lane)
    const int n = o / kWarpVals, j = o / 128 % kTiles, i = o / 32 % 4;
    const int ln = o % 32;
    // reg i of tile j: row (g + 8 (i / 2)) = column 2j + i / 2 of lane
    // group g, column (2t + i % 2) = row of x
    bo[e] = 2 * (ln % 4) + i % 2;
    co[e] = col0 + n * kWarpCols + (ln / 4) * kLaneBytes + 2 * j + i / 2;
    v[e] = red[o];
#pragma unroll
    for (int wi = 1; wi < kWarpsK; ++wi)
      v[e] += red[wi * kWarpsN * kWarpVals + o];
  }
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    if (bo[e] >= B || co[e] >= N) continue;
    const long long o = (long long)bo[e] * N + co[e];
    if (ksplit == 1)
      store_out(out, out_bf16, o, __fmul_rn(v[e], scale[co[e]]));
    else
      planes[(long long)cy * B * N + o] = v[e];
  }
  if (ksplit == 1) return;

  // the last CTA of this column block to arrive sums the planes in order
  __threadfence();
  __syncthreads();
  if (tid == 0) *last = atomicAdd(counters + cx, 1) == ksplit - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  constexpr int kPlanes = 8;   // planes' loads in flight before their adds
  float sum[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) sum[e] = 0.f;
  for (int p0 = 0; p0 < ksplit; p0 += kPlanes) {
    float pv[kPlanes][kPer];
#pragma unroll
    for (int q = 0; q < kPlanes; ++q)
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        pv[q][e] = p0 + q < ksplit && bo[e] < B && co[e] < N
                       ? __ldcg(planes + ((long long)(p0 + q) * B + bo[e]) *
                                             N + co[e])
                       : 0.f;
#pragma unroll
    for (int q = 0; q < kPlanes; ++q)
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        if (p0 + q < ksplit) sum[e] += pv[q][e];
  }
#pragma unroll
  for (int e = 0; e < kPer; ++e)
    if (bo[e] < B && co[e] < N)
      store_out(out, out_bf16, (long long)bo[e] * N + co[e],
                __fmul_rn(sum[e], scale[co[e]]));
  if (tid == 0) counters[cx] = 0;  // ready for the next launch
}

template <int V>
int launch(const void* x, int x_bf16, const int8_t* w, const float* scale,
           float* planes, int* counters, void* out, int out_bf16, int B,
           int K, int N, int kc, int ksplit, cudaStream_t stream) {
  // the ring (later the warps' sums) and the last-CTA flag
  const size_t smem = kRingBytes + 16;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        wq_gemv_mma<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((N + kCols - 1) / kCols, ksplit);
  wq_gemv_mma<V><<<grid, kThreads, smem, stream>>>(
      x, x_bf16, w, scale, planes, counters, out, out_bf16, B, K, N, kc,
      ksplit);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, K) float32 or (x_bf16) bfloat16, w (K, N) int8, scale (N,) float32,
// out (B, N) float32 or (out_bf16) bfloat16, all contiguous on the device
// of `stream`; planes (ksplit, B, N) float32 scratch and counters
// (ceil(N / 128),) int32, all zero, used when ksplit > 1 (and left zero).
// args: B, K, N, kc (K rows a CTA), ksplit, vec (the weight's copy width
// in bytes: 16, 8, 4 or 1, dividing N and the weight's address), x_bf16,
// out_bf16.
extern "C" int wq_gemv(const void* x, const int8_t* w, const float* scale,
                       float* planes, int* counters, void* out,
                       const int* args, cudaStream_t stream) {
  const int B = args[0], K = args[1], N = args[2], kc = args[3];
  const int ksplit = args[4], vec = args[5], x_bf16 = args[6];
  const int out_bf16 = args[7];
  if (B < 1 || B > kMaxB || K < 1 || N < 1 || kc < 1 || ksplit < 1 ||
      ksplit > 65535 || (long long)kc * (ksplit - 1) >= K ||
      (long long)kc * ksplit < K ||
      (vec != 16 && vec != 8 && vec != 4 && vec != 1) || N % vec != 0 ||
      reinterpret_cast<uintptr_t>(w) % vec != 0 ||
      (ksplit > 1 && (planes == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  switch (vec) {
    case 16:
      return launch<16>(x, x_bf16, w, scale, planes, counters, out, out_bf16,
                        B, K, N, kc, ksplit, stream);
    case 8:
      return launch<8>(x, x_bf16, w, scale, planes, counters, out, out_bf16,
                       B, K, N, kc, ksplit, stream);
    case 4:
      return launch<4>(x, x_bf16, w, scale, planes, counters, out, out_bf16,
                       B, K, N, kc, ksplit, stream);
    default:
      return launch<1>(x, x_bf16, w, scale, planes, counters, out, out_bf16,
                       B, K, N, kc, ksplit, stream);
  }
}

// the constants the wrapper's planner copies
extern "C" void wq_gemv_tiles(int* t) {
  t[0] = kCols;
  t[1] = kStageRows;
  t[2] = kThreads;
  t[3] = kRingBytes;
}

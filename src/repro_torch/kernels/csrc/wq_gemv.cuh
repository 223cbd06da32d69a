// The streaming weight-only GEMV on the bf16 tensor cores, shared by
// wq_gemv.cu (an int8 weight, one k row a byte row) and int4_gemv.cu (a
// nibble-packed int4 weight, two k rows a byte row): out (B, N) = (x (B,
// K) @ w (K, N)) * scale[col], x float32 or bfloat16 with B <= 8, out
// float32 or bfloat16 (rounded once in the epilogue).
//
// Bound on this card: bytes.  Each weight byte is used B <= 8 times (16
// for a packed byte), so the least time is the weight's bytes over the HBM
// bandwidth.  On the CUDA cores the B float multiply-adds a weight, and
// its conversion, cost more issue slots than the byte takes to arrive; so
// the products run on the tensor cores, and what is left a weight is its
// decode.
//
// Design.  The product is computed transposed, out^T (N, B) = w^T (N, K) @
// x^T (K, B), as mma.sync.m16n8k16 bf16 tiles with f32 accumulators: 16
// weight columns are the tile's rows, the (up to) 8 rows of x its columns.
//   * A CTA of 256 threads owns kCols = 128 weight columns and walks its K
//     chunk in stages of F::kSteps k16 steps a warp: 64 k rows (64 int8
//     byte rows) or 128 (64 packed ones).  Each stage -- its weight rows
//     (16-byte cp.async copies; 8-, 4- or 1-byte where N, or the weight's
//     address, is not a multiple of 16) and its k rows of each row of x
//     (16-byte copies where K and the chunk starts are multiples of 4,
//     else 4-byte ones) -- streams through a ring of F::kStages shared-
//     memory buffers, all but one of them in flight while one is consumed,
//     so neither the copies in flight nor a long K chunk costs registers
//     or more shared memory.  Rows past the chunk, and rows of x past B,
//     are zero-filled.  The loop is issue-bound (at B = 8 a stage's bytes
//     arrive faster than its instructions issue), so each thread's copy
//     addresses are set up once and advanced a stage at a time (Copies).
//   * Each warp takes F::kSteps 16-row k steps of every stage and 64
//     columns as 4 m16 tiles: K is split over 4 warps, N over 2.  A lane
//     reads 8 bytes (8 columns) of each byte row it needs, and its tile
//     rows are mapped so that those bytes are exactly the A-fragment
//     values it needs (F::frags): tile j's rows g and g + 8 are its
//     columns 2j and 2j + 1.  Each A register holds the k pair (2t,
//     2t + 1) (and + 8) of one column: for int8 one byte of each of two
//     rows, decoded without a conversion instruction (the byte in the
//     mantissa of 2^23 offset by 128, less 2^23 + 128, exact; the float's
//     high half is the bfloat16); for int4 the two nibbles of one packed
//     byte, which hold exactly that k pair: (nibble ^ 8) in the low
//     mantissa bits of bfloat16 128.0 is 136 + the nibble's value, less
//     136 in bf16x2 (exact).  Every int8 and int4 value is a bfloat16
//     value.
//   * x's values are split in registers into three bfloat16 terms whose
//     sum is the float32 value (f32_terms.cuh, split3), so three mma per
//     tile give the float32 product, each term product exact (a bfloat16
//     x is one term, and three products with two of them zero).
//   * After the K loop the 4 K warps' accumulators are summed in shared
//     memory in a fixed order and, with one K chunk, multiplied by the
//     column scale and stored.  Where one column block has too few rows to
//     keep the card busy, K is split over ksplit CTAs (quant_gemm.wq_plan
//     sizes it; a packed chunk starts on a whole byte row): each writes its
//     partial sums to a float32 plane, and the last CTA of a column block
//     to arrive -- a __threadfence and a counter per column block, which
//     that CTA sets back to zero (split_k.cuh, split_k_last_sum, shared
//     with gemv.cu) -- sums the planes in plane order, so the result does
//     not depend on which CTA came last and no atomic touches the output.
//     The column scale is applied once, after the whole K sum, as the
//     reference applies it after its whole K loop.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "dtypes.cuh"
#include "f32_terms.cuh"
#include "split_k.cuh"

namespace wq {

constexpr int kThreads = 256;                // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kWarpsN = 2;                   // warps side by side along N
constexpr int kWarpsK = kWarps / kWarpsN;    // warps splitting K
constexpr int kCols = 128;                   // weight columns per CTA
constexpr int kWarpCols = kCols / kWarpsN;   // a warp's columns
constexpr int kLaneBytes = kWarpCols / 8;    // a lane's bytes of a byte row
constexpr int kTiles = kWarpCols / 16;       // m16 tiles a warp
constexpr int kStepRows = 16 * kWarpsK;      // k rows of a k16 step a warp
constexpr int kMaxB = 8;                     // the mma's n8
constexpr int kCtasPerSm = 3;                // the register budget's CTAs
static_assert(kLaneBytes == 8 || kLaneBytes == 16,
              "a lane's A fragments are one 8- or 16-byte load a row");

// kLaneBytes bytes of one byte row as words
__device__ __forceinline__ void lane_words(const int8_t* p,
                                           unsigned (&wd)[kLaneBytes / 4]) {
  if constexpr (kLaneBytes == 16) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    wd[0] = q.x, wd[1] = q.y, wd[2] = q.z, wd[3] = q.w;
  } else {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    wd[0] = q.x, wd[1] = q.y;
  }
}

// An int8 weight: a byte row is a k row.  A stage is one k16 step a warp.
struct Int8 {
  static constexpr int kRowsPerByte = 1;
  static constexpr int kSteps = 1;
  static constexpr int kStages = 4;

  // the bfloat16 pair {v(byte p of lo), v(byte p of hi)} of two words
  // whose bytes are each int8 v + 128: 2^23 + (v + 128) less 2^23 + 128 is
  // v, exactly, and a float with at most 8 significant bits is its high
  // half
  static __device__ __forceinline__ unsigned pair(unsigned lo, unsigned hi,
                                                  int p) {
    const float a =
        __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7540 | p)) - 8388736.f;
    const float b =
        __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7540 | p)) - 8388736.f;
    return hi_halves(__float_as_uint(a), __float_as_uint(b));
  }

  // a warp's A fragments of its k16 step (k rows kk .. kk + 15 of the
  // stage): this lane's columns col .. col + kLaneBytes - 1 of rows kk +
  // 2t, + 1, + 8, + 9
  static __device__ __forceinline__ void frags(const int8_t* st, int kk,
                                               int col, int t,
                                               unsigned (&a)[kTiles][4]) {
    constexpr unsigned m = 0x80808080u;   // each byte v -> v + 128
    const int8_t* wr = st + (kk + 2 * t) * kCols + col;
    unsigned w0[kLaneBytes / 4], w1[kLaneBytes / 4];
    unsigned w8[kLaneBytes / 4], w9[kLaneBytes / 4];
    lane_words(wr, w0);
    lane_words(wr + kCols, w1);
    lane_words(wr + 8 * kCols, w8);
    lane_words(wr + 9 * kCols, w9);
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      // tile j's rows g and g + 8 are this lane's columns 2j and 2j + 1
      const int wd = j / 2, p = 2 * (j % 2);
      a[j][0] = pair(w0[wd] ^ m, w1[wd] ^ m, p);
      a[j][1] = pair(w0[wd] ^ m, w1[wd] ^ m, p + 1);
      a[j][2] = pair(w8[wd] ^ m, w9[wd] ^ m, p);
      a[j][3] = pair(w8[wd] ^ m, w9[wd] ^ m, p + 1);
    }
  }
};

// A nibble-packed int4 weight: byte row kp holds k rows 2kp (low nibble)
// and 2kp + 1 (high nibble).  A stage is two k16 steps a warp (64 packed
// rows, the int8 stage's bytes): a stage's fixed work -- the wait, the
// barrier, the copies' addresses -- weighs on half as many bytes per step.
struct Int4 {
  static constexpr int kRowsPerByte = 2;
  static constexpr int kSteps = 2;
  static constexpr int kStages = 4;

  // the bfloat16 pair {low nibble, high nibble} of byte p of u (sh = u >>
  // 4): each nibble n ^ 8 in the low mantissa bits of bfloat16 128.0
  // (0x4300) is 128 + (n ^ 8) = 136 + the nibble's signed value; less 136
  // (0xC308) by one bf16x2 FMA, exact
  static __device__ __forceinline__ unsigned pair(unsigned u, unsigned sh,
                                                  int p) {
    // (b & 0x000F000F) ^ 0x43084308 as one LOP3 (lut 0x6A: (a & b) ^ c)
    unsigned b;
    asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n"
        : "=r"(b)
        : "r"(__byte_perm(u, sh, p | ((p + 4) << 8))), "r"(0x000F000Fu),
          "r"(0x43084308u));
    unsigned r;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
        : "=r"(r)
        : "r"(b), "r"(0x3F803F80u), "r"(0xC308C308u));
    return r;
  }

  // a warp's A fragments of its k16 step (k rows kk .. kk + 15, packed
  // rows kk / 2 .. kk / 2 + 7 of the stage): packed rows kk / 2 + t (k
  // rows kk + 2t, + 1) and kk / 2 + t + 4 (+ 8, + 9), this lane's columns
  // col .. col + kLaneBytes - 1
  static __device__ __forceinline__ void frags(const int8_t* st, int kk,
                                               int col, int t,
                                               unsigned (&a)[kTiles][4]) {
    const int8_t* wr = st + (kk / 2 + t) * kCols + col;
    unsigned u0[kLaneBytes / 4], u4[kLaneBytes / 4];
    lane_words(wr, u0);
    lane_words(wr + 4 * kCols, u4);
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      const int wd = j / 2, p = 2 * (j % 2);
      const unsigned s0 = u0[wd] >> 4, s4 = u4[wd] >> 4;
      a[j][0] = pair(u0[wd], s0, p);
      a[j][1] = pair(u0[wd], s0, p + 1);
      a[j][2] = pair(u4[wd], s4, p);
      a[j][3] = pair(u4[wd], s4, p + 1);
    }
  }
};

// a stage of format F: its byte rows of the weight, then x (kXLd floats
// a row of x)
template <typename F>
struct Ring {
  static constexpr int kStageRows = kStepRows * F::kSteps;   // k rows
  static constexpr int kWRows = kStageRows / F::kRowsPerByte;
  static constexpr int kXLd = kStageRows + 8;
  static constexpr int kStageBytes = kWRows * kCols + kMaxB * kXLd * 4;
  static constexpr int kBytes = F::kStages * kStageBytes;
  static_assert(kStageBytes % 16 == 0, "16-byte copies into every stage");
};

// x's forms: float32 in 4-byte copies, bfloat16 (widened at the load), or
// float32 in 16-byte copies (K and the chunk starts multiples of 4, x
// 16-byte aligned)
enum XMode { kXF32 = 0, kXBf16 = 1, kXF32Vec = 2 };

// One thread's copies into the ring, their addresses set up once and
// advanced a stage at a time (the stages are issued in order): its pieces
// of the weight's byte rows -- kW pieces of V bytes in one column c of the
// CTA's kCols, rows r0, r0 + kRowStep, ... (pieces tid, tid + kThreads,
// ... of the stage, row-major) -- and its values of x's kMaxB rows (4 of
// one row with 16-byte copies, else kStageRows * kMaxB / kThreads single
// values).  Columns past N, rows past the chunk and x rows past B are
// zero-filled (from w and x themselves, which are then not read).  V: the
// weight's copy width, dividing N and its address.
template <typename F, int V>
struct Copies {
  static constexpr int kPerRow = kCols / V, kRowStep = kThreads / kPerRow;
  static constexpr int kW = Ring<F>::kWRows / kRowStep;
  static constexpr int kStageRows = Ring<F>::kStageRows;
  static constexpr int kXLd = Ring<F>::kXLd, kRowPieces = kStageRows / 4;
  static_assert(kThreads % kPerRow == 0 && kW * kRowStep == Ring<F>::kWRows,
                "every thread copies whole rows' pieces");
  static_assert(kMaxB * kRowPieces <= kThreads, "one 16-byte x copy a thread");

  const int8_t* w;    // the weight (the zero-fill copies' source)
  const int8_t* wp;   // this thread's first piece of the next stage
  long long wstage;   // a stage's bytes of the weight
  long long wpiece;   // the weight's bytes from one of its pieces to the next
  int wdst, wrow;     // its first piece's offset in a stage, and byte row
  bool wcol;          // its column lies before N
  const void* x;
  const float* xp;    // its 4 values of x in the next stage (16-byte x)
  int xdst, xrow;     // their offset in a stage (bytes), and first k row
  bool xcopy, xlive;  // it copies x (16-byte x); its x row lies before B
  long long k;        // the next stage's first k
  int left;           // the chunk's k rows from the next stage on

  __device__ __forceinline__ Copies(const int8_t* w_, const void* x_, int B,
                                    int K, long long N, int k0, int len,
                                    int col0, int tid) {
    const int r = tid / kPerRow, c = tid % kPerRow * V;
    w = w_;
    wp = w_ + (k0 / F::kRowsPerByte + r) * N + col0 + c;
    wstage = Ring<F>::kWRows * N;
    wpiece = kRowStep * N;
    wdst = r * kCols + c;
    wrow = r;
    wcol = col0 + c < N;
    const int b = tid / kRowPieces;
    xrow = tid % kRowPieces * 4;
    xcopy = tid < kMaxB * kRowPieces;
    xlive = xcopy && b < B;
    xdst = Ring<F>::kWRows * kCols + 4 * (b * kXLd + xrow);
    x = x_;
    xp = static_cast<const float*>(x_) +
         (xlive ? (long long)b * K + k0 + xrow : 0);
    k = k0;
    left = len;
  }

  // the copies of the next stage into the ring slot st
  __device__ __forceinline__ void issue(int8_t* st, int x_mode, int B, int K,
                                        int tid) {
    const int wrows = (left + F::kRowsPerByte - 1) / F::kRowsPerByte;
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      const bool ok = wcol && wrow + i * kRowStep < wrows;
      int8_t* d = st + wdst + i * kRowStep * kCols;
      const int8_t* sp = ok ? wp + i * wpiece : w;
      if constexpr (V == 16)
        cp_async16(d, sp, ok ? 16 : 0);
      else if constexpr (V == 8 || V == 4)
        cp_async_ca<V>(d, sp, ok ? V : 0);
      else
        *d = ok ? *sp : 0;
    }
    if (x_mode == kXF32Vec) {
      const int n = xlive ? max(0, min(4, left - xrow)) : 0;
      if (xcopy) cp_async16(st + xdst, n ? xp : x, 4 * n);
    } else {
      float* xd = reinterpret_cast<float*>(st + Ring<F>::kWRows * kCols);
#pragma unroll
      for (int i = 0; i < kMaxB * kStageRows / kThreads; ++i) {
        const int e = tid + i * kThreads, b = e / kStageRows;
        const int r = e % kStageRows;
        const bool ok = b < B && r < left;
        const long long at = (long long)b * K + k + r;
        if (x_mode == kXBf16)
          xd[b * kXLd + r] =
              ok ? widen(static_cast<const bf16*>(x)[at]) : 0.f;
        else
          cp_async_ca<4>(xd + b * kXLd + r,
                         static_cast<const float*>(x) + (ok ? at : 0),
                         ok ? 4 : 0);
      }
    }
    wp += wstage;
    xp += kStageRows;
    k += kStageRows;
    left -= kStageRows;
  }
};

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

template <typename F, int V>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
wq_gemv_mma(const void* __restrict__ x, int x_mode,
            const int8_t* __restrict__ w, const float* __restrict__ scale,
            float* __restrict__ planes, int* __restrict__ counters,
            void* __restrict__ out, int out_bf16, int B, int K, int N,
            int kc, int ksplit) {
  using R = Ring<F>;
  constexpr int kStages = F::kStages, kStageRows = R::kStageRows;
  extern __shared__ float4 smem4[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem4);   // kStages stages
  int* last = reinterpret_cast<int*>(ring + R::kBytes);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wn = warp % kWarpsN, wk = warp / kWarpsN;
  const int cx = blockIdx.x, cy = blockIdx.y;
  const int k0 = cy * kc, len = min(K, k0 + kc) - k0;   // k0 on a byte row
  const int col0 = cx * kCols;
  const int stages = (len + kStageRows - 1) / kStageRows;
  Copies<F, V> copies(w, x, B, K, N, k0, len, col0, tid);
  auto load = [&](int s) {   // s: the next stage
    copies.issue(ring + (s % kStages) * R::kStageBytes, x_mode, B, K, tid);
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
    const int8_t* st = ring + (s % kStages) * R::kStageBytes;
#pragma unroll
    for (int h = 0; h < F::kSteps; ++h) {
      // this warp's k16 step, k rows kk + 2t, + 1, + 8, + 9 of the stage,
      // and its kWarpCols columns
      const int kk = 16 * wk + kStepRows * h;
      unsigned a[kTiles][4];
      F::frags(st, kk, wn * kWarpCols + g * kLaneBytes, t, a);
      // x^T's B fragments: row g of x, k rows 2t, 2t + 1 (b0), + 8 (b1)
      const float* xr =
          reinterpret_cast<const float*>(st + R::kWRows * kCols) +
          g * R::kXLd + kk + 2 * t;
      const float2 x0 = *reinterpret_cast<const float2*>(xr);
      const float2 x8 = *reinterpret_cast<const float2*>(xr + 8);
      unsigned b0[3], b1[3];
      split_pair_exact(x0.x, x0.y, b0);
      split_pair_exact(x8.x, x8.y, b1);
#pragma unroll
      for (int j = 0; j < kTiles; ++j)
#pragma unroll
        for (int e = 0; e < 3; ++e) mma16816_bf16(acc[j], a[j], b0[e], b1[e]);
    }
  }

  // the K warps' sums, in order; (wk, wn, tile, reg, lane) in the ring
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);
  constexpr int kWarpVals = kTiles * 4 * 32;
  static_assert(kWarps * kWarpVals * 4 <= R::kBytes, "the sums fit the ring");
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
  long long at[kPer];
  bool live[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    at[e] = (long long)bo[e] * N + co[e];
    live[e] = bo[e] < B && co[e] < N;
  }
  float sum[kPer];
  if (!split_k_last_sum<kPer>(planes, (long long)B * N, ksplit, counters + cx,
                              last, at, live, sum))
    return;
#pragma unroll
  for (int e = 0; e < kPer; ++e)
    if (live[e])
      store_out(out, out_bf16, at[e], __fmul_rn(sum[e], scale[co[e]]));
}

template <typename F, int V>
int launch(const void* x, int x_mode, const int8_t* w, const float* scale,
           float* planes, int* counters, void* out, int out_bf16, int B,
           int K, int N, int kc, int ksplit, cudaStream_t stream) {
  // the ring (later the warps' sums) and the last-CTA flag
  const size_t smem = Ring<F>::kBytes + 16;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        wq_gemv_mma<F, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((N + kCols - 1) / kCols, ksplit);
  wq_gemv_mma<F, V><<<grid, kThreads, smem, stream>>>(
      x, x_mode, w, scale, planes, counters, out, out_bf16, B, K, N, kc,
      ksplit);
  return (int)cudaGetLastError();
}

// The C entries' body: check the arguments, pick the copy width.  x (B, K)
// float32 or (x_bf16) bfloat16; w the weight in format F, (K / F::
// kRowsPerByte rounded up, N) bytes; scale (N,) float32; out (B, N)
// float32 or (out_bf16) bfloat16, all contiguous on the device of
// `stream`; planes (ksplit, B, N) float32 scratch and counters (ceil(N /
// 128),) int32, all zero, used when ksplit > 1 (and left zero).  kc: K
// rows a CTA, a whole number of byte rows where K is split; vec: the
// weight's copy width in bytes, 16, 8, 4 or 1, dividing N and the
// weight's address.
template <typename F>
int run(const void* x, const int8_t* w, const float* scale, float* planes,
        int* counters, void* out, int B, int K, int N, int kc, int ksplit,
        int vec, int x_bf16, int out_bf16, cudaStream_t stream) {
  if (B < 1 || B > kMaxB || K < 1 || N < 1 || kc < 1 || ksplit < 1 ||
      ksplit > 65535 || (long long)kc * (ksplit - 1) >= K ||
      (long long)kc * ksplit < K ||
      (ksplit > 1 && kc % F::kRowsPerByte != 0) ||
      (vec != 16 && vec != 8 && vec != 4 && vec != 1) || N % vec != 0 ||
      reinterpret_cast<uintptr_t>(w) % vec != 0 ||
      (ksplit > 1 && (planes == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int x_mode =
      x_bf16 ? kXBf16
             : K % 4 == 0 && (ksplit == 1 || kc % 4 == 0) &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0
                   ? kXF32Vec
                   : kXF32;
  switch (vec) {
    case 16:
      return launch<F, 16>(x, x_mode, w, scale, planes, counters, out,
                           out_bf16, B, K, N, kc, ksplit, stream);
    case 8:
      return launch<F, 8>(x, x_mode, w, scale, planes, counters, out,
                          out_bf16, B, K, N, kc, ksplit, stream);
    case 4:
      return launch<F, 4>(x, x_mode, w, scale, planes, counters, out,
                          out_bf16, B, K, N, kc, ksplit, stream);
    default:
      return launch<F, 1>(x, x_mode, w, scale, planes, counters, out,
                          out_bf16, B, K, N, kc, ksplit, stream);
  }
}

}  // namespace wq

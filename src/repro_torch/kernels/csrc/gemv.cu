// Small-batch GEMV, out (B, N) = x (B, K) @ w (K, N), B <= 8, for Hopper
// (sm_90a), on the CUDA cores: float32 or bfloat16 operands (one dtype),
// widened to float32 at the load, float32 FMA sums, and a float32 or
// bfloat16 output rounded once at the end.
//
// Replaces: src/repro/kernels/gemv.py::gemv (pallas_call at gemv.py:59),
// the TPU kernel that streams W once over a (N blocks, K blocks) grid with
// a VMEM-resident f32 accumulator.
//
// Bound on this card: bytes.  Every weight is used B <= 8 times: at most 8
// FMAs a 4-byte float32 weight, 8 a 2-byte bfloat16 one.  At the full HBM
// rate an SM receives about 14.5 bytes a cycle (3.35 TB/s over 132 SMs at
// ~1.75 GHz), so float32 asks for about 29 FMA lanes a cycle, ~23 % of the
// SM's 128, and bfloat16 about 58 lanes and one widening a value, ~45 %.
// The CUDA cores are not the limit (the int8 / int4 GEMVs, whose weight
// decode costs more issue slots a byte, run on the tensor cores instead):
// the kernel's one job is to keep enough weight bytes in flight, in wide
// copies, on every SM, from the first cycle to the last.  The least time is
// the K * N weight bytes over the HBM bandwidth.
//
// Design.
//   * A CTA of 256 threads (8 warps) owns kCols = 128 columns, 4 a lane,
//     and walks its K chunk in stages of kStageBytes = 16 KB of weight: 32
//     float32 rows or 64 bfloat16 rows of its 128 columns, and the same k
//     rows of the (up to) 8 rows of x.  Each stage streams through a ring
//     of kStages shared-memory slots by cp.async, all but one of them in
//     flight while one is consumed: 48 KB in flight a CTA, two CTAs an SM,
//     so neither the bytes in flight nor a long K chunk costs registers or
//     more shared memory.  The weight is copied 16 bytes at a time where
//     the row pitch (N elements) and the weight's address allow, else 8, 4
//     or (bfloat16) 2 bytes; x streams in the same stage, 16 bytes at a
//     time where K, the chunk starts and x's address allow, else one value
//     at a time, so a CTA's first weight copy never waits for x.  Columns
//     past N, rows past the chunk and rows of x past B are zero-filled.
//   * The stage's rows are taken 4 at a time (a group), group g by warp g
//     % 8: a lane reads its 4 columns of the group's 4 rows (one 16- or
//     8-byte shared load a row) and the 4 values of each row of x (one
//     broadcast load each), and keeps 8 x 4 float32 sums, adding each row's
//     products in row order with fmaf.  K is split over the 8 warps; after
//     the K loop their sums are added in shared memory in warp order.
//   * Where the column blocks are too few to keep the card busy, K is split
//     over ksplit CTAs (gemv.gemv_plan sizes it): each writes its partial
//     sums to a float32 plane, and the last CTA of a column block to arrive
//     sums the planes in plane order in the same launch (split_k.cuh,
//     split_k_last_sum: a __threadfence and a counter per column block,
//     which that CTA sets back to zero), so the result is deterministic and
//     a call is one launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "dtypes.cuh"
#include "split_k.cuh"

namespace {

constexpr int kThreads = 256;               // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 128;                  // columns a CTA
constexpr int kLaneCols = kCols / 32;       // a lane's columns
constexpr int kMaxB = 8;
constexpr int kGroup = 4;                   // k rows a warp takes at a time
constexpr int kStageBytes = 16384;          // weight bytes a stage
constexpr int kStages = 4;
constexpr int kCtasPerSm = 2;               // the register budget's CTAs

// a stage of operand type T: its weight rows (kRows x kCols), then its k
// rows of each of the kMaxB rows of x
template <typename T>
struct Ring {
  static constexpr int kRows = kStageBytes / (kCols * (int)sizeof(T));
  static constexpr int kXBytes = kMaxB * kRows * (int)sizeof(T);
  static constexpr int kSlot = kStageBytes + kXBytes;
  static constexpr int kBytes = kStages * kSlot;
  static constexpr int kWarpGroups = kRows / (kGroup * kWarps);  // a stage
  static_assert(kWarpGroups * kGroup * kWarps == kRows,
                "every warp takes whole groups of every stage");
  static_assert(kSlot % 16 == 0, "16-byte copies into every slot");
};

// x's forms: 16-byte copies, or one value at a time
enum XMode { kXOne = 0, kXVec = 1 };

// One thread's copies into the ring, their addresses set up once and
// advanced a stage at a time (the stages are issued in order): kW pieces of
// V bytes of the weight, in one column piece c of the CTA's kCols, rows r0,
// r0 + kRowStep, ... (pieces tid, tid + kThreads, ... of the stage,
// row-major), and its share of x's kMaxB x kRows values.  V: the weight's
// copy width, dividing the row pitch and the weight's address.
template <typename T, int V>
struct Copies {
  using R = Ring<T>;
  static constexpr int kRowBytes = kCols * (int)sizeof(T);
  static constexpr int kPerRow = kRowBytes / V, kRowStep = kThreads / kPerRow;
  static constexpr int kW = R::kRows / kRowStep;
  static constexpr int kXPieces = kMaxB * R::kRows * (int)sizeof(T) / 16;
  static constexpr int kXEach = 16 / (int)sizeof(T);  // values a 16-B piece
  static_assert(V >= (int)sizeof(T) && kThreads % kPerRow == 0 &&
                    kW * kRowStep == R::kRows,
                "every thread copies whole rows' pieces");
  static_assert(kXPieces <= kThreads, "one 16-byte x copy a thread");
  static_assert(kMaxB * R::kRows % kThreads == 0, "x's values split evenly");

  const char* w;      // the weight (the zero-fill copies' source)
  const char* wp;     // this thread's first piece of the next stage
  long long wstage;   // a stage's bytes of the weight
  long long wpiece;   // the weight's bytes from one of its pieces to the next
  int wdst, wrow;     // its first piece's offset in a slot, and its row
  bool wcol;          // its columns lie before N
  const T* x;
  const T* xp;        // its piece of x in the next stage (16-byte x)
  int xdst, xcol;     // its piece's offset in a slot (values), first k row
  bool xcopy, xlive;  // it copies x (16-byte x); its x row lies before B
  long long k;        // the next stage's first k
  int left;           // the chunk's k rows from the next stage on

  __device__ __forceinline__ Copies(const T* w_, const T* x_, int B, int K,
                                    long long N, int k0, int len, int col0,
                                    int tid) {
    const int r = tid / kPerRow, c = tid % kPerRow * V;
    constexpr long long e = sizeof(T);
    w = reinterpret_cast<const char*>(w_);
    wp = w + ((k0 + r) * N + col0) * e + c;
    wstage = R::kRows * N * e;
    wpiece = kRowStep * N * e;
    wdst = r * kRowBytes + c;
    wrow = r;
    wcol = col0 + c / (int)e < N;
    const int b = tid / (kXPieces / kMaxB);
    xcol = tid % (kXPieces / kMaxB) * kXEach;
    xcopy = tid < kXPieces;
    xlive = xcopy && b < B;
    xdst = b * R::kRows + xcol;
    x = x_;
    xp = x_ + (xlive ? (long long)b * K + k0 + xcol : 0);
    k = k0;
    left = len;
  }

  // the copies of the next stage into the ring slot st
  __device__ __forceinline__ void issue(char* st, int x_mode, int B, int K,
                                        int tid) {
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      const bool ok = wcol && wrow + i * kRowStep < left;
      char* d = st + wdst + i * kRowStep * kRowBytes;
      const char* sp = ok ? wp + i * wpiece : w;
      if constexpr (V == 16)
        cp_async16(d, sp, ok ? 16 : 0);
      else if constexpr (V == 8 || V == 4)
        cp_async_ca<V>(d, sp, ok ? V : 0);
      else   // a bfloat16 weight with an odd pitch or address: 2 bytes
        *reinterpret_cast<uint16_t*>(d) =
            ok ? __ldg(reinterpret_cast<const unsigned short*>(sp)) : 0;
    }
    T* xs = reinterpret_cast<T*>(st + kStageBytes);
    if (x_mode == kXVec) {
      const int n = xlive ? max(0, min(kXEach, left - xcol)) : 0;
      if (xcopy) cp_async16(xs + xdst, n ? xp : x, n * (int)sizeof(T));
    } else {
#pragma unroll
      for (int i = 0; i < kMaxB * R::kRows / kThreads; ++i) {
        const int v = tid + i * kThreads, b = v / R::kRows;
        const int r = v % R::kRows;
        const bool ok = b < B && r < left;
        const T* src = x + (ok ? (long long)b * K + k + r : 0);
        if constexpr (sizeof(T) == 4)
          cp_async_ca<4>(xs + v, src, ok ? 4 : 0);
        else
          xs[v] = ok ? *src : T();
      }
    }
    wp += wstage;
    xp += R::kRows;
    k += R::kRows;
    left -= R::kRows;
  }
};

// 4 neighbouring values of shared memory as float32 (16 bytes of float32,
// 8 of bfloat16, widened exactly: a bfloat16 is a float's high half)
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16), v[1] = __uint_as_float(q.x & 0xFFFF0000u);
  v[2] = __uint_as_float(q.y << 16), v[3] = __uint_as_float(q.y & 0xFFFF0000u);
}

__device__ __forceinline__ void store_out(void* out, int out_bf16,
                                          long long i, float v) {
  if (out_bf16)
    static_cast<bf16*>(out)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(out)[i] = v;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
gemv_stream(const T* __restrict__ x, int x_mode, const T* __restrict__ w,
            float* __restrict__ planes, int* __restrict__ counters,
            void* __restrict__ out, int out_bf16, int B, int K, int N,
            int kc, int ksplit) {
  using R = Ring<T>;
  extern __shared__ float4 smem4[];
  char* ring = reinterpret_cast<char*>(smem4);   // kStages slots
  int* last = reinterpret_cast<int*>(ring + R::kBytes);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cx = blockIdx.x, cy = blockIdx.y;
  const int k0 = cy * kc, len = min(K, k0 + kc) - k0;
  const int col0 = cx * kCols;
  const int stages = (len + R::kRows - 1) / R::kRows;
  Copies<T, V> copies(w, x, B, K, N, k0, len, col0, tid);
  auto load = [&](int s) {   // s: the next stage
    copies.issue(ring + (s % kStages) * R::kSlot, x_mode, B, K, tid);
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < stages) load(s);
    cp_async_commit();
  }
  float acc[kMaxB][kLaneCols];
#pragma unroll
  for (int b = 0; b < kMaxB; ++b)
#pragma unroll
    for (int c = 0; c < kLaneCols; ++c) acc[b][c] = 0.f;
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<kStages - 2>();  // stage s has landed
    __syncthreads();               // ... for every thread; stage s - 1 is free
    if (s + kStages - 1 < stages) load(s + kStages - 1);
    cp_async_commit();
    const char* st = ring + (s % kStages) * R::kSlot;
    const T* ws = reinterpret_cast<const T*>(st);
    const T* xs = reinterpret_cast<const T*>(st + kStageBytes);
#pragma unroll
    for (int g = 0; g < R::kWarpGroups; ++g) {
      const int r0 = (g * kWarps + warp) * kGroup;   // the group's rows
      float wv[kGroup][kLaneCols];
#pragma unroll
      for (int r = 0; r < kGroup; ++r)
        load4(ws + (r0 + r) * kCols + lane * kLaneCols, wv[r]);
#pragma unroll
      for (int b = 0; b < kMaxB; ++b) {
        float xv[kGroup];
        load4(xs + b * R::kRows + r0, xv);
#pragma unroll
        for (int r = 0; r < kGroup; ++r)
#pragma unroll
          for (int c = 0; c < kLaneCols; ++c)
            acc[b][c] = fmaf(xv[r], wv[r][c], acc[b][c]);
      }
    }
  }

  // the warps' sums, in warp order: (warp, b, column) in the ring
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);
  static_assert(kWarps * kMaxB * kCols * 4 <= R::kBytes,
                "the sums fit the ring");
#pragma unroll
  for (int b = 0; b < kMaxB; ++b)
    *reinterpret_cast<float4*>(red + (warp * kMaxB + b) * kCols +
                               lane * kLaneCols) =
        make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
  __syncthreads();
  // this thread's outputs: row b = tid / 32 of x, columns c .. c + 3
  constexpr int kPer = kMaxB * kCols / kThreads;
  static_assert(kPer == kLaneCols, "a thread sums one lane's columns");
  const int b = tid / 32, c = lane * kLaneCols;
  float v[kPer];
  load4(red + b * kCols + c, v);
#pragma unroll
  for (int wi = 1; wi < kWarps; ++wi) {
    float u[kPer];
    load4(red + (wi * kMaxB + b) * kCols + c, u);
#pragma unroll
    for (int e = 0; e < kPer; ++e) v[e] += u[e];
  }
  long long at[kPer];
  bool live[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    at[e] = (long long)b * N + col0 + c + e;
    live[e] = b < B && col0 + c + e < N;
  }
  if (ksplit == 1) {
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      if (live[e]) store_out(out, out_bf16, at[e], v[e]);
    return;
  }
  float* plane = planes + (long long)cy * B * N;
#pragma unroll
  for (int e = 0; e < kPer; ++e)
    if (live[e]) plane[at[e]] = v[e];
  float sum[kPer];
  if (!split_k_last_sum<kPer>(planes, (long long)B * N, ksplit, counters + cx,
                              last, at, live, sum))
    return;
#pragma unroll
  for (int e = 0; e < kPer; ++e)
    if (live[e]) store_out(out, out_bf16, at[e], sum[e]);
}

template <typename T, int V>
int launch(const T* x, int x_mode, const T* w, float* planes, int* counters,
           void* out, int out_bf16, int B, int K, int N, int kc, int ksplit,
           cudaStream_t stream) {
  // the ring (later the warps' sums) and the last-CTA flag
  const size_t smem = Ring<T>::kBytes + 16;
  auto kern = gemv_stream<T, V>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kCols - 1) / kCols, ksplit);
  kern<<<grid, kThreads, smem, stream>>>(x, x_mode, w, planes, counters, out,
                                         out_bf16, B, K, N, kc, ksplit);
  return (int)cudaGetLastError();
}

// check the arguments, pick x's form and the weight's copy width
template <typename T>
int run(const void* xv, const void* wv, float* planes, int* counters,
        void* out, int B, int K, int N, int kc, int ksplit, int vec,
        int out_bf16, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  constexpr int e = sizeof(T);
  if (B < 1 || B > kMaxB || K < 1 || N < 1 || kc < 1 || ksplit < 1 ||
      ksplit > 65535 || (long long)kc * (ksplit - 1) >= K ||
      (long long)kc * ksplit < K ||
      (vec != 16 && vec != 8 && vec != 4 && vec != 2) || vec < e ||
      (long long)N * e % vec != 0 ||
      reinterpret_cast<uintptr_t>(w) % vec != 0 ||
      (ksplit > 1 && (planes == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int x_mode = (long long)K * e % 16 == 0 &&
                             (ksplit == 1 || kc * e % 16 == 0) &&
                             reinterpret_cast<uintptr_t>(x) % 16 == 0
                         ? kXVec
                         : kXOne;
  switch (vec) {
    case 16:
      return launch<T, 16>(x, x_mode, w, planes, counters, out, out_bf16, B,
                           K, N, kc, ksplit, stream);
    case 8:
      return launch<T, 8>(x, x_mode, w, planes, counters, out, out_bf16, B,
                          K, N, kc, ksplit, stream);
    case 4:
      return launch<T, 4>(x, x_mode, w, planes, counters, out, out_bf16, B,
                          K, N, kc, ksplit, stream);
    default:
      if constexpr (sizeof(T) == 2)
        return launch<T, 2>(x, x_mode, w, planes, counters, out, out_bf16, B,
                            K, N, kc, ksplit, stream);
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B, K), w (K, N) float32 or (in_bf16) bfloat16, out (B, N) float32 or
// (out_bf16) bfloat16, all contiguous on the device of `stream`; planes
// (ksplit, B, N) float32 scratch and counters (ceil(N / 128),) int32, all
// zero, used when ksplit > 1 (and left zero).  args: B, K, N, kc (K rows a
// CTA), ksplit, vec (the weight's copy width in bytes: 16, 8, 4 or, for
// bfloat16, 2, dividing N's bytes and the weight's address), in_bf16,
// out_bf16.
extern "C" int gemv(const void* x, const void* w, float* planes,
                    int* counters, void* out, const int* args,
                    cudaStream_t stream) {
  const int B = args[0], K = args[1], N = args[2], kc = args[3];
  const int ksplit = args[4], vec = args[5], in_bf16 = args[6];
  const int out_bf16 = args[7];
  return in_bf16 ? run<bf16>(x, w, planes, counters, out, B, K, N, kc,
                             ksplit, vec, out_bf16, stream)
                 : run<float>(x, w, planes, counters, out, B, K, N, kc,
                              ksplit, vec, out_bf16, stream);
}

// the constants the wrapper's planner copies
extern "C" void gemv_tiles(int* t) {
  constexpr int kRingBytes = Ring<float>::kBytes;
  static_assert(Ring<bf16>::kBytes == kRingBytes, "one ring for both types");
  t[0] = kCols;
  t[1] = kThreads;
  t[2] = kStageBytes;
  t[3] = kStages;
  t[4] = kRingBytes;
  t[5] = kCtasPerSm;
}

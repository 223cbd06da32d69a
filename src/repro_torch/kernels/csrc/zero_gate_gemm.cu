// Block-sparse zero-gated GeMM, for Hopper (sm_90a), on the CUDA cores:
// out (M, N) = a (M, K) @ b (K, N), where the products of every (mbm, mbk)
// block of A whose occupancy mask[i, l] is 0 are skipped.  a and b are
// float32 or bfloat16 (one dtype, widened to float32 exactly), the sums
// float32, out float32 or bfloat16, rounded once.
//
// Replaces: src/repro/kernels/zero_gate_gemm.py::zero_gate_gemm
// (pallas_call at zero_gate_gemm.py:75), the TPU kernel with an (M, N, K)
// grid that reads mask[i, l] at each K step and skips that step's MXU pass
// when it is 0, accumulating in an f32 VMEM scratch cast once at the last
// K step.  It is the TPU's time-saving translation of the paper's
// MAC-level zero gating.
//
// Bound on this card: operations for the prefill-width calls (M = 128:
// 256 FLOP per float32 weight element, above the fp32 CUDA-core rate's ~20
// FLOP per HBM byte), bytes for the decode calls (M = 8).  Float32 stays
// on the CUDA cores with fmaf: TF32 tensor cores keep about three decimal
// digits, which is not the reference's f32 function.
//
// Split-K, on the mask's K blocks.  Both forms split K into chunks whose
// edges are K-block edges or lie inside one block: a run of `bpc` whole
// mask K blocks, or (bpc = 1) one of `sub` pieces of kc rows of a block;
// the wrapper sizes them so that about two CTAs sit on each SM.  A CTA
// walks its chunk block by block, and where all of its rows are dead in a
// block it issues neither the loads nor the products of that block's rows.
// Each chunk writes its own f32 partial plane of a scratch the wrapper
// allocates -- zeros where every block of it is gated off or it lies past
// the last, ragged, K block, so garbage is never summed -- and a second
// kernel sums the planes in chunk order and rounds to the output type,
// with no atomics.  One chunk writes the output directly.  A CTA that
// straddles live and dead row blocks loads the dead rows as zeros, so it
// computes exactly the reference's function for any mask a caller passes.
//
// Prefill width (M > 8): a pipelined SIMT GeMM.  A CTA of 256 threads owns
// a (BM, 128) output tile, BM in {32, 64, 128}; each thread a (BM/16) x 8
// register tile (BM/16 neighbouring rows, two runs of 4 neighbouring
// columns), so a warp owns BM/8 neighbouring rows and skips its products
// in a K block where the mask kills all of them: a fine mask (32-row
// blocks under a 128-row tile) saves the dead blocks' FMAs, not only
// whole K blocks' loads.
// K is walked 32 deep through a ring of kStages (3) stages in dynamic
// shared memory, filled with 16-byte cp.async (dead rows and edges
// zero-filled), so the loads of stage t + 2 overlap the FMAs of stage t.
//
// Decode (M <= 8): a streaming form.  A CTA of 128 threads owns 128 * V
// neighbouring columns (V = 16 bytes of b per thread per row: 4 float32 or
// 8 bfloat16) and one K chunk: up to xs_rows rows at a time of the M rows
// of a sit in shared memory (dead rows as zeros) and each thread streams
// its V columns of b with one 16-byte load per k row, so b is read once.
//
// Ragged K, N or mbk, or an operand not 16-byte aligned, take the same
// loops with element loads instead of 16-byte ones.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "dtypes.cuh"
#include "split_k.cuh"

namespace {

constexpr int kThreads = 256;     // tile form: 16 x 16
constexpr int kBN = 128;          // tile form: output columns per CTA
constexpr int kStep = 32;         // tile form: K depth of one stage
constexpr int kStages = 3;
constexpr int kTileCtasPerSm = 2; // tile form: occupancy (at most 128 regs)
constexpr int kStreamThreads = 128;
constexpr int kMaxRows = 8;       // stream form: rows of a
constexpr int kMaxXsRows = 2048;  // stream form: K rows of a held at once

struct zg_sum;  // names the split-K sum's instances in a profile

// four neighbouring values at p (8- or 16-byte aligned), widened
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
  v[0] = __low2float(lo); v[1] = __high2float(lo);
  v[2] = __low2float(hi); v[3] = __high2float(hi);
}

// chunk c of the K split: rows [k0, kend), starting in block l0
struct Chunk {
  int l0, k0, kend;
  __device__ Chunk(int c, int K, int mbk, int kc, int sub, int bpc) {
    l0 = (c / sub) * bpc;
    k0 = l0 * mbk + (c % sub) * kc;
    const int span = sub > 1 ? kc : bpc * mbk;
    kend = min(min(k0 + span, (l0 + bpc) * mbk), K);
  }
};

// ---------------------------------------------------------------------------
// prefill width: the pipelined tile
// ---------------------------------------------------------------------------

// grid (ceil(N / kBN), ceil(M / BM), chunks)
template <int BM, bool VEC, typename T, typename TO>
__global__ void __launch_bounds__(kThreads, kTileCtasPerSm)
zg_tile(const int* __restrict__ mask, const T* __restrict__ a,
        const T* __restrict__ b, void* __restrict__ dst, int M, int K, int N,
        int mbm, int mbk, int nkb, int kc, int sub, int bpc) {
  constexpr int TM = BM / 16;
  constexpr int V = 16 / sizeof(T);          // elements per 16-byte piece
  constexpr int AS = kStep + V;              // A row stride (16-byte pad)
  constexpr int kStageElems = BM * AS + kStep * kBN;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  __shared__ int live[BM];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const Chunk ch(blockIdx.z, K, mbk, kc, sub, bpc);

  float acc[TM][8];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  // stage of K rows [k, k + kStep) clipped to s1, into ring slot `slot`
  auto load = [&](int slot, int k0, int s1) {
    T* As = ring + slot * kStageElems;
    T* Bs = As + BM * AS;
    for (int p = tid; p < BM * (kStep / V); p += kThreads) {
      const int r = p / (kStep / V), q = p % (kStep / V);
      const int m = m0 + r, k = k0 + q * V;
      T* d = As + r * AS + q * V;
      const bool rowok = m < M && live[r];
      if (VEC) {
        const bool ok = rowok && k < s1;
        cp_async16(d, ok ? a + (long long)m * K + k : a, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          d[j] = (rowok && k + j < s1) ? a[(long long)m * K + k + j]
                                       : narrow<T>(0.f);
      }
    }
    for (int p = tid; p < kStep * (kBN / V); p += kThreads) {
      const int r = p / (kBN / V), q = p % (kBN / V);
      const int k = k0 + r, n = n0 + q * V;
      T* d = Bs + r * kBN + q * V;
      if (VEC) {
        const bool ok = k < s1 && n < N;
        cp_async16(d, ok ? b + (long long)k * N + n : b, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          d[j] = (k < s1 && n + j < N) ? b[(long long)k * N + n + j]
                                       : narrow<T>(0.f);
      }
    }
  };

  for (int l = ch.l0; l < nkb && l * mbk < ch.kend; ++l) {
    const int s0 = max(ch.k0, l * mbk), s1 = min(ch.kend, (l + 1) * mbk);
    if (s0 >= s1) continue;
    __syncthreads();  // the last block's stages and live rows are used
    int any = 0;
    for (int r = tid; r < BM; r += kThreads) {
      const int m = m0 + r;
      const int on = m < M ? mask[(long long)(m / mbm) * nkb + l] != 0 : 0;
      live[r] = on;
      any |= on;
    }
    if (!__syncthreads_or(any)) continue;   // the block gated off
    // a warp whose rows are all dead in this block skips its products
    bool mine = false;
#pragma unroll
    for (int r = 0; r < TM; ++r) mine |= live[ty * TM + r] != 0;
    const bool warp_live = __any_sync(0xffffffffu, mine);

    const int nt = (s1 - s0 + kStep - 1) / kStep;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nt) load(s, s0 + s * kStep, s1);
      cp_async_commit();
    }
    for (int t = 0; t < nt; ++t) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // stage t landed; the slot of stage t - 1 is free
      const int next = t + kStages - 1;
      if (next < nt) load(next % kStages, s0 + next * kStep, s1);
      cp_async_commit();
      if (!warp_live) continue;
      const T* As = ring + (t % kStages) * kStageElems;
      const T* Bs = As + BM * AS;
#pragma unroll
      for (int kk = 0; kk < kStep; kk += 4) {
        float av[TM][4];
#pragma unroll
        for (int r = 0; r < TM; ++r)
          load4(As + (ty * TM + r) * AS + kk, av[r]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float lo[4], hi[4];
          load4(Bs + (kk + q) * kBN + 4 * tx, lo);
          load4(Bs + (kk + q) * kBN + 64 + 4 * tx, hi);
#pragma unroll
          for (int r = 0; r < TM; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              acc[r][c] = fmaf(av[r][q], lo[c], acc[r][c]);
              acc[r][c + 4] = fmaf(av[r][q], hi[c], acc[r][c + 4]);
            }
        }
      }
    }
    cp_async_wait<0>();
  }

  // the tile's sums (zeros where every block was gated off), in pairs of
  // neighbouring columns
  const bool whole = gridDim.z == 1, vec = N % 2 == 0;
  float* plane = static_cast<float*>(dst) + (long long)blockIdx.z * M * N;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int m = m0 + ty * TM + r;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < 8; c += 2) {
      const int n = n0 + (c < 4 ? 0 : 64) + 4 * tx + c % 4;
      if (n >= N) continue;
      const long long o = (long long)m * N + n;
      const bool two = n + 1 < N;
      if (whole)
        store2(static_cast<TO*>(dst) + o, acc[r][c], acc[r][c + 1], two, vec);
      else
        store2(plane + o, acc[r][c], acc[r][c + 1], two, vec);
    }
  }
}

// ---------------------------------------------------------------------------
// decode: the streaming form
// ---------------------------------------------------------------------------

// grid (ceil(N / (kStreamThreads * V)), chunks); shared memory
// M * xs_stride floats, xs_stride = xs_rows rounded up to 4
template <bool VEC, typename T, typename TO>
__global__ void __launch_bounds__(kStreamThreads)
zg_stream(const int* __restrict__ mask, const T* __restrict__ a,
          const T* __restrict__ b, void* __restrict__ dst, int M, int K,
          int N, int mbm, int mbk, int nkb, int kc, int sub, int bpc,
          int xs_rows) {
  constexpr int V = 16 / sizeof(T);
  constexpr int R = 8;                       // b rows loaded at once
  extern __shared__ __align__(16) float xs[];   // (M, xs_stride): rows of a
  const int xs_stride = (xs_rows + 3) & ~3;
  const int tid = threadIdx.x;
  const int n = (blockIdx.x * kStreamThreads + tid) * V;
  const Chunk ch(blockIdx.y, K, mbk, kc, sub, bpc);

  float acc[kMaxRows][V];
#pragma unroll
  for (int m = 0; m < kMaxRows; ++m)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[m][v] = 0.f;

  // row k (of the piece at bp) of this thread's V columns of b, widened
  auto load_row = [&](const T* bp, int k, float (&w)[V]) {
    if (VEC) {
      const uint4 raw = *reinterpret_cast<const uint4*>(bp + (long long)k * N);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int v = 0; v < V; ++v) w[v] = widen(e[v]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v)
        w[v] = n + v < N ? widen(bp[(long long)k * N + v]) : 0.f;
    }
  };

  for (int l = ch.l0; l < nkb && l * mbk < ch.kend; ++l) {
    const int s0 = max(ch.k0, l * mbk), s1 = min(ch.kend, (l + 1) * mbk);
    bool rowlive[kMaxRows];
    bool any = false;   // the same for every thread of the CTA
#pragma unroll
    for (int m = 0; m < kMaxRows; ++m) {
      rowlive[m] = m < M && mask[(long long)(m / mbm) * nkb + l] != 0;
      any |= rowlive[m];
    }
    if (!any) continue;                      // the block gated off
    for (int p0 = s0; p0 < s1; p0 += xs_rows) {
      const int len = min(xs_rows, s1 - p0);
      __syncthreads();  // the last piece's rows of a are used
      for (int i = tid; i < M * len; i += kStreamThreads) {
        const int m = i / len, k = i - m * len;
        xs[m * xs_stride + k] =
            rowlive[m] ? widen(a[(long long)m * K + p0 + k]) : 0.f;
      }
      __syncthreads();
      if (n >= N) continue;
      const T* bp = b + (long long)p0 * N + n;
      int k = 0;
      for (; k + R <= len; k += R) {       // R rows of b in flight
        float w[R][V];
#pragma unroll
        for (int r = 0; r < R; ++r) load_row(bp, k + r, w[r]);
#pragma unroll
        for (int m = 0; m < kMaxRows; ++m) {
          if (m >= M) break;
          const float4* xm =
              reinterpret_cast<const float4*>(xs + m * xs_stride + k);
          const float4 x0 = xm[0], x1 = xm[1];
          const float x[R] = {x0.x, x0.y, x0.z, x0.w,
                              x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[m][v] = fmaf(x[r], w[r][v], acc[m][v]);
        }
      }
      for (; k < len; ++k) {               // the piece's last rows
        float w[V];
        load_row(bp, k, w);
#pragma unroll
        for (int m = 0; m < kMaxRows; ++m) {
          if (m >= M) break;
          const float x = xs[m * xs_stride + k];
#pragma unroll
          for (int v = 0; v < V; ++v) acc[m][v] = fmaf(x, w[v], acc[m][v]);
        }
      }
    }
  }

  if (n >= N) return;
  const bool whole = gridDim.y == 1, vec = N % 2 == 0;
  float* plane = static_cast<float*>(dst) + (long long)blockIdx.y * M * N;
#pragma unroll
  for (int m = 0; m < kMaxRows; ++m) {
    if (m >= M) break;
#pragma unroll
    for (int v = 0; v < V; v += 2) {
      if (n + v >= N) break;
      const long long o = (long long)m * N + n + v;
      const bool two = n + v + 1 < N;
      if (whole)
        store2(static_cast<TO*>(dst) + o, acc[m][v], acc[m][v + 1], two, vec);
      else
        store2(plane + o, acc[m][v], acc[m][v + 1], two, vec);
    }
  }
}

// opt `kern` in to `bytes` of dynamic shared memory, once per size above
// what `allowed` (the call site's own record) already covers
template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

template <bool VEC, typename T, typename TO>
int launch(const int* mask, const T* a, const T* b, float* partial,
           void* out, int M, int K, int N, int mbm, int mbk, int bm, int kc,
           int sub, int bpc, int chunks, cudaStream_t stream) {
  const int nkb = (K + mbk - 1) / mbk;
  void* dst = chunks == 1 ? out : static_cast<void*>(partial);
  cudaError_t err;
  if (M <= kMaxRows) {
    constexpr int V = 16 / sizeof(T);
    const int xs_rows = min(kMaxXsRows, sub > 1 ? kc : mbk);
    const size_t smem = sizeof(float) * (size_t)M * ((xs_rows + 3) & ~3);
    static size_t allowed = 48 * 1024;
    err = allow_smem(zg_stream<VEC, T, TO>, smem, allowed);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((N + kStreamThreads * V - 1) / (kStreamThreads * V),
                    chunks);
    zg_stream<VEC, T, TO><<<grid, kStreamThreads, smem, stream>>>(
        mask, a, b, dst, M, K, N, mbm, mbk, nkb, kc, sub, bpc, xs_rows);
  } else {
#define ZG_TILE(BM_)                                                        \
  if (bm == BM_) {                                                          \
    constexpr int V = 16 / sizeof(T);                                       \
    const size_t smem = sizeof(T) * kStages *                               \
                        (size_t)(BM_ * (kStep + V) + kStep * kBN);          \
    static size_t allowed = 48 * 1024;                                      \
    err = allow_smem(zg_tile<BM_, VEC, T, TO>, smem, allowed);              \
    if (err != cudaSuccess) return (int)err;                                \
    const dim3 grid((N + kBN - 1) / kBN, (M + BM_ - 1) / BM_, chunks);      \
    zg_tile<BM_, VEC, T, TO><<<grid, kThreads, smem, stream>>>(             \
        mask, a, b, dst, M, K, N, mbm, mbk, nkb, kc, sub, bpc);             \
  } else
    ZG_TILE(32) ZG_TILE(64) ZG_TILE(128)
    return (int)cudaErrorInvalidValue;
#undef ZG_TILE
  }
  if (chunks > 1) {
    const long long MN = (long long)M * N;
    launch_split_k_sum<zg_sum, TO>(partial, nullptr, static_cast<TO*>(out),
                                   N, MN, chunks, stream);
  }
  return (int)cudaGetLastError();
}

template <typename T, typename TO>
int run(const int* mask, const void* a_, const void* b_, float* partial,
        void* out, int M, int K, int N, int mbm, int mbk, int bm, int kc,
        int sub, int bpc, int chunks, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* a = static_cast<const T*>(a_);
  const T* b = static_cast<const T*>(b_);
  // the stream form loads b rows only; the tile form also a rows, from
  // chunk and block starts
  const bool vec = N % V == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                   (M <= kMaxRows ||
                    (K % V == 0 && mbk % V == 0 && kc % V == 0 &&
                     reinterpret_cast<uintptr_t>(a) % 16 == 0));
  return vec ? launch<true, T, TO>(mask, a, b, partial, out, M, K, N, mbm,
                                   mbk, bm, kc, sub, bpc, chunks, stream)
             : launch<false, T, TO>(mask, a, b, partial, out, M, K, N, mbm,
                                    mbk, bm, kc, sub, bpc, chunks, stream);
}

}  // namespace

// mask (ceil(M / mbm), ceil(K / mbk)) int32; a (M, K), b (K, N) float32
// (in_bf16 = 0) or bfloat16 (in_bf16 = 1); out (M, N) float32 or
// (out_bf16 = 1) bfloat16; partial (chunks, M, N) float32 scratch (unused
// with one chunk); all contiguous.  The K split: `chunks` chunks, each a
// run of bpc whole mask K blocks (sub = 1, kc = mbk) or one of sub pieces
// of kc rows of one block (bpc = 1).  M <= 8 takes the streaming form; M >
// 8 the tile form with bm (32, 64 or 128) rows per CTA.
extern "C" int zero_gate_gemm(const int* mask, const void* a, const void* b,
                              float* partial, void* out, int M, int K, int N,
                              int mbm, int mbk, int bm, int kc, int sub,
                              int bpc, int chunks, int in_bf16, int out_bf16,
                              cudaStream_t stream) {
  const int nkb = (K + mbk - 1) / mbk;
  if (M < 1 || K < 1 || N < 1 || mbm < 1 || mbk < 1 || kc < 1 ||
      kc > mbk || sub < 1 || bpc < 1 || chunks < 1 || chunks > 65535 ||
      (sub > 1 ? bpc > 1 || (long long)kc * sub < mbk || chunks != nkb * sub
               : (long long)chunks * bpc < nkb) ||
      (M > kMaxRows && (M + bm - 1) / bm > 65535))
    return (int)cudaErrorInvalidValue;
  return IO_DISPATCH(in_bf16, out_bf16, run, mask, a, b, partial, out, M, K,
                     N, mbm, mbk, bm, kc, sub, bpc, chunks, stream);
}

// The constants the wrapper's planner (zero_gate_gemm.py: zg_split_k)
// sizes its grid by, for it to check once at load: tile columns, tile K
// step, tile CTAs per SM, stream threads, stream rows.
extern "C" void zero_gate_gemm_tiles(int* t) {
  t[0] = kBN;
  t[1] = kStep;
  t[2] = kTileCtasPerSm;
  t[3] = kStreamThreads;
  t[4] = kMaxRows;
}

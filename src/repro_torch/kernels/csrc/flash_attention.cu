// Float flash attention (forward), for Hopper (sm_90a), on the tensor
// cores: out (B, H, Sq, dh) from q (B, H, Sq, dh) and k, v (B, KvH, Skv,
// dh), float32 or bfloat16 (one type for all four).  Query head h reads KV
// group h / rep.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_fwd
// (pallas_call at flash_attention.py:99), the TPU kernel with a (B, H,
// q blocks, kv blocks) grid whose last axis walks the kv blocks in order,
// carrying the running max, denominator and output accumulator in VMEM.
// Per kv block of bkv rows: s = (q k^T) * dh^-0.5 with f32 accumulation,
// masked to -1e30 where k_idx >= Skv or (causal) k_idx > q_idx; m_new =
// max(m, rowmax s); p = exp(s - m_new); corr = exp(m - m_new); l = l * corr
// + rowsum p; acc = acc * corr + p.astype(v.dtype) @ v (f32 accumulation);
// out = acc / max(l, 1e-30).  For bfloat16 operands p is rounded to
// bfloat16 before PV against the running max over its whole block, so the
// kv blocks are part of the function and this kernel walks the same ones
// (bkv <= 128).  The q blocks are not: rows are independent, so the
// kernel's q tile is its own.
//
// Bound on this card: at Yi-9B's prefill shapes (Sq = Skv = 512, dh =
// 128) the products, 2 * 512 FLOP per K / V value a head reads, against
// the bytes of q, k, v and out; at the bf16 tensor rate the bytes bound
// it (about 0.045 ms against 0.017 for the operations), but a float32
// operand takes six bf16 products (below), which puts its floor at the
// operations.
//
// Design (the FA2 layout on mma.sync.m16n8k16 bf16 x bf16 -> f32):
//   * One CTA per (b, h, q tile): 16 query rows a warp, 8 warps (128 rows)
//     for float32 operands, 4 (64 rows, two CTAs an SM) for bfloat16.  The
//     q tile stays in shared memory; each kv block's K and V arrive by
//     cp.async into one buffer each, K of the next block loading while
//     this block's softmax and PV run, V while the next QK^T runs.
//   * QK^T: a warp's 16 x bkv scores stay in registers, f32.  A fragments
//     from the q tile, B fragments from K rows (a k pair of one kv row is
//     what one B register holds).  bfloat16 operands are read with
//     ldmatrix and take one product; float32 ones are read as float32
//     pairs and split in registers into three exact bfloat16 terms
//     (f32_terms.cuh, split3_fast), six term products kept: q0 k0 apart
//     from the five small ones, summed once per score (sum_terms).  Not
//     TF32.
//   * The block's row max first (over all its columns: a reduction over
//     the lane quad), then p = exp(s - m_new) in the log2 domain, l and
//     the rescaled accumulator.  p stays in registers: the scores' m16n8
//     accumulator layout is the next product's A fragment.  bfloat16: p
//     rounded to bfloat16, V's B fragments by ldmatrix.trans, one product.
//     float32: p split into three terms, V read as float32 and split, six
//     products into the output accumulator.
//   * Code size.  A float32 step's body is long (the splits of every
//     fragment), and unrolled over all the k16 steps of both products the
//     kernel ran markedly slower on the card: the float32 steps run as
//     loops (PV's step takes its scores from the registers by an unrolled
//     select), the short bfloat16 ones unrolled.
//   * Skipped work.  A kv block whose first column lies past the q tile's
//     last live row is masked for every row of the tile; with finite
//     operands its p is exp(-1e30 - m) = 0 and its corr exp(0) = 1, so l
//     and acc stay bit for bit as they are, and the tile never loads it.
//     Inside a computed block a warp skips the score tiles and PV steps
//     past its own last row's causal limit (the same zeros).  This holds
//     for finite operands only: a non-finite v in a skipped block makes
//     the reference's output NaN and not this kernel's.  The q tiles are
//     launched heaviest first (the last rows have the most blocks).
//   * bkv and dh need not be multiples of 16: the block's columns past bkv
//     are masked (p = 0) against zero rows of K and V, and dh is padded
//     with zero columns.  Rows or dh * size not a multiple of 16 bytes,
//     or an operand not 16-byte aligned, take element loads instead of
//     cp.async.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "dtypes.cuh"
#include "f32_terms.cuh"

namespace {

constexpr int kTile = 128;     // max bkv and dh
constexpr int kGroups = kTile / 32;   // score tiles in groups of 4 n8 tiles
constexpr float kNegInf = -1e30f;

// per operand type: warps (16 query rows each), CTAs an SM, and the row
// strides of the q / K tiles (LQK) and of the V tile (LV), in elements
template <typename T>
struct Cfg;
template <>
struct Cfg<float> {
  static constexpr int kWarps = 8;
  static constexpr int kCtas = 1;
  // 8 mod 32 floats: a half-warp's float2 pair reads hit 32 banks
  static constexpr int kLQK = kTile + 8;
  // 4 mod 32 floats: frag_b_f32's column reads hit 32 banks
  static constexpr int kLV = kTile + 4;
};
template <>
struct Cfg<bf16> {
  static constexpr int kWarps = 4;
  static constexpr int kCtas = 2;
  // 272 bytes: ldmatrix's 8 rows on distinct banks
  static constexpr int kLQK = kTile + 8;
  static constexpr int kLV = kTile + 8;
};

template <typename T>
struct Smem {
  static constexpr int kRows = 16 * Cfg<T>::kWarps;   // the q tile's rows
  static constexpr int kQ = kRows * Cfg<T>::kLQK;
  static constexpr int kK = kTile * Cfg<T>::kLQK;
  static constexpr int kV = kTile * Cfg<T>::kLV;
  static constexpr size_t kBytes = sizeof(T) * (size_t)(kQ + kK + kV);
};

// rows [0, rows) x columns [0, dh) of a tile with row stride ld from src
// (row stride dh): rows past `valid` are zeros.  vec: 16-byte cp.async
// pieces (dh * sizeof(T) a multiple of 16, src 16-byte aligned), each
// thread one piece column of every per-th row (one division a call), else
// element loads.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          int valid, int rows, int dh,
                                          bool vec, int tid, int nthreads) {
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);
    const int pieces = dh / kPer, per = nthreads / pieces;
    const int c = tid % pieces * kPer;
    for (int r = tid / pieces; r < rows && tid < per * pieces; r += per) {
      const bool ok = r < valid;
      cp_async16(dst + r * ld + c, ok ? src + (long long)r * dh + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < rows * dh; e += nthreads) {
      const int r = e / dh, c = e % dh;
      dst[r * ld + c] = r < valid ? src[(long long)r * dh + c]
                                  : narrow<T>(0.f);
    }
  }
}

// The B fragment (k16 x n8) of a float32 tile stored [n][k] (row stride
// LD floats; columns n0 .. n0 + 7, k0 .. k0 + 15), split into its three
// bfloat16 terms: lane (g, t) reads the k pairs 2t and 2t + 8 of row g
template <int LD>
__device__ __forceinline__ void frag_bt_f32(unsigned (&b)[3][2],
                                            const float* tile, int n0,
                                            int k0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float* p = tile + (n0 + g) * LD + k0 + 2 * t;
  const float2 v0 = *reinterpret_cast<const float2*>(p);
  const float2 v1 = *reinterpret_cast<const float2*>(p + 8);
  unsigned s[3], u[3];
  split_pair(v0.x, v0.y, s);
  split_pair(v1.x, v1.y, u);
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    b[e][0] = s[e];
    b[e][1] = u[e];
  }
}

__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
__global__ void __launch_bounds__(32 * Cfg<T>::kWarps, Cfg<T>::kCtas)
fa_mma(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, T* __restrict__ out, int H, int KvH, int Sq,
       int Skv, int dh, int bkv, float scale_log2, int causal, int vec) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kWarps = Cfg<T>::kWarps, kThreads = 32 * kWarps;
  constexpr int LQ = Cfg<T>::kLQK, LV = Cfg<T>::kLV;
  constexpr int kRows = Smem<T>::kRows;
  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);
  T* Ks = Qs + Smem<T>::kQ;
  T* Vs = Ks + Smem<T>::kK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  // q tiles heaviest first: the last rows see the most causal blocks
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int kvh = h / (H / KvH);
  const T* qt = q + (((long long)b * H + h) * Sq + q0) * dh;
  const T* kg = k + ((long long)b * KvH + kvh) * Skv * dh;
  const T* vg = v + ((long long)b * KvH + kvh) * Skv * dh;
  const int dh16 = (dh + 15) & ~15, bkv16 = (bkv + 15) & ~15;
  const int nk = (Skv + bkv - 1) / bkv;
  // the blocks this tile computes: with a causal mask, none past the one
  // holding its last live row's diagonal (the rest are masked for all
  // its rows, and leave every row's state as it is)
  const int q_last = min(q0 + kRows, Sq) - 1;
  const int blocks = causal ? min(nk, q_last / bkv + 1) : nk;

  // the padding columns dh .. dh16 - 1 stay zero (no load writes them)
  for (int e = tid; e < (kRows + kTile) * (dh16 - dh); e += kThreads) {
    const int r = e / (dh16 - dh), c = dh + e % (dh16 - dh);
    if (r < kRows)
      Qs[r * LQ + c] = narrow<T>(0.f);
    else
      Ks[(r - kRows) * LQ + c] = narrow<T>(0.f);
  }
  for (int e = tid; e < kTile * (dh16 - dh); e += kThreads)
    Vs[e / (dh16 - dh) * LV + dh + e % (dh16 - dh)] = narrow<T>(0.f);

  auto load_k = [&](int j) {
    const int kv0 = j * bkv;
    load_rows(Ks, LQ, kg + (long long)kv0 * dh, min(bkv, Skv - kv0), bkv16,
              dh, vec, tid, kThreads);
  };
  auto load_v = [&](int j) {
    const int kv0 = j * bkv;
    load_rows(Vs, LV, vg + (long long)kv0 * dh, min(bkv, Skv - kv0), bkv16,
              dh, vec, tid, kThreads);
  };
  load_rows(Qs, LQ, qt, min(kRows, Sq - q0), kRows, dh, vec, tid, kThreads);
  load_k(0);
  cp_async_commit();   // q and K of block 0
  load_v(0);
  cp_async_commit();   // V of block 0

  const int r0 = q0 + 16 * warp;              // the warp's first row
  const int w_last = min(r0 + 15, Sq - 1);    // its last live row
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kTile / 8][4];
#pragma unroll
  for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;

  for (int j = 0; j < blocks; ++j) {
    const int kv0 = j * bkv;
    const int cols = min(bkv, Skv - kv0);     // the block's real columns
    // the columns this warp computes: none past its last row's diagonal,
    // none at all where its rows lie past Sq
    const int ncols = r0 >= Sq ? 0 : causal ? min(cols, w_last - kv0 + 1)
                                            : cols;
    cp_async_wait<1>();   // q and this block's K have landed
    __syncthreads();

    // S = q K^T, 16 x bkv a warp, in registers as groups of 4 n8 tiles.
    // float32: the k16 steps of dh run as a loop (each step's body is long,
    // and unrolled over every step the code ran slower); bfloat16: all
    // unrolled
    float s[kGroups][4][4];
#pragma unroll
    for (int gr = 0; gr < kGroups; ++gr)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[gr][jj][i] = 0.f;
    if constexpr (kF32) {
      const float* Qf = reinterpret_cast<const float*>(Qs);
      const float* Kf = reinterpret_cast<const float*>(Ks);
#pragma unroll
      for (int gr = 0; gr < kGroups; ++gr) {
        if (32 * gr >= ncols) continue;
        float lo[4][4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int i = 0; i < 4; ++i) lo[jj][i] = 0.f;
#pragma unroll 1
        for (int ks = 0; ks < dh16; ks += 16) {
          unsigned a[3][4], bb[4][3][2];
          frag_a_f32<LQ>(a, Qf, 16 * warp, ks);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            frag_bt_f32<LQ>(bb[jj], Kf, 32 * gr + 8 * jj, ks);
          mma_terms<3, 4>(s[gr], lo, a, bb);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[gr][jj][i] = sum_terms(s[gr][jj][i],
                                                               lo[jj][i]);
      }
    } else {
      const uint16_t* Q16 = reinterpret_cast<const uint16_t*>(Qs);
      const uint16_t* K16 = reinterpret_cast<const uint16_t*>(Ks);
#pragma unroll
      for (int ks = 0; ks < kTile; ks += 16) {
        if (ks >= dh16 || ncols <= 0) continue;
        unsigned a[4];
        ldsm_x4(a, Q16 + (16 * warp + lane % 16) * LQ + ks + 8 * (lane / 16));
#pragma unroll
        for (int gr = 0; gr < kGroups; ++gr) {
          if (32 * gr >= ncols) continue;
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            // n8 tiles 2jp and 2jp + 1 of the group, both k halves
            unsigned r[4];
            ldsm_x4(r, K16 + (32 * gr + 16 * jp + lane % 8 +
                              8 * (lane / 16)) * LQ +
                             ks + 8 * ((lane / 8) % 2));
            mma16816_bf16(s[gr][2 * jp], a, r[0], r[1]);
            mma16816_bf16(s[gr][2 * jp + 1], a, r[2], r[3]);
          }
        }
      }
    }
    __syncthreads();                      // every warp is done with K
    if (j + 1 < blocks) load_k(j + 1);
    cp_async_commit();

    // the block's row max, then p, l and the rescaled accumulator; rows g
    // (h2 = 0) and g + 8 (h2 = 1) of the warp
    float mx[2] = {kNegInf, kNegInf};
    if (ncols > 0) {
#pragma unroll
      for (int gr = 0; gr < kGroups; ++gr)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = 32 * gr + 8 * jj + 2 * t + i % 2;
            const int row = r0 + g + 8 * (i / 2);
            const bool live = c < cols && (!causal || kv0 + c <= row);
            s[gr][jj][i] = live ? s[gr][jj][i] * scale_log2 : kNegInf;
            mx[i / 2] = fmaxf(mx[i / 2], s[gr][jj][i]);
          }
    }
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 1));
      mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 2));
    }
    if (ncols > 0) {
      float m_new[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) m_new[h2] = fmaxf(m[h2], mx[h2]);
#pragma unroll
      for (int gr = 0; gr < kGroups; ++gr)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[gr][jj][i] = exp2_approx(s[gr][jj][i] - m_new[i / 2]);
            psum[i / 2] += s[gr][jj][i];
          }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        psum[h2] += __shfl_xor_sync(0xffffffffu, psum[h2], 1);
        psum[h2] += __shfl_xor_sync(0xffffffffu, psum[h2], 2);
        const float corr = exp2_approx(m[h2] - m_new[h2]);
        l[h2] = l[h2] * corr + psum[h2];
        m[h2] = m_new[h2];
#pragma unroll
        for (int n = 0; n < kTile / 8; ++n) {
          o[n][2 * h2] *= corr;
          o[n][2 * h2 + 1] *= corr;
        }
      }
    }

    cp_async_wait<1>();   // this block's V has landed
    __syncthreads();
    // acc += p V: k16 step c covers the block's columns 16c .. 16c + 15,
    // which are score tiles 2c and 2c + 1
    if constexpr (kF32) {
      // the steps as a loop (a float32 step's body is long), each taking
      // its 8 scores from the registers by an unrolled select
#pragma unroll 1
      for (int c = 0; c < (ncols + 15) / 16; ++c) {
        float p[8];
#pragma unroll
        for (int cc = 0; cc < kTile / 16; ++cc)
          if (cc == c)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              p[i] = s[cc / 2][2 * (cc % 2)][i];
              p[4 + i] = s[cc / 2][2 * (cc % 2) + 1][i];
            }
        unsigned a[3][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          unsigned sp[3];
          split_pair(p[2 * r], p[2 * r + 1], sp);
#pragma unroll
          for (int e = 0; e < 3; ++e) a[e][r] = sp[e];
        }
#pragma unroll
        for (int n = 0; n < kTile / 8; ++n) {
          if (8 * n >= dh16) continue;
          unsigned bb[3][2];
          frag_b_f32<LV>(bb, reinterpret_cast<const float*>(Vs), 16 * c,
                         8 * n);
#pragma unroll
          for (int pr = 0; pr < 6; ++pr)
            mma16816_bf16(o[n], a[term_a(pr)], bb[term_b(pr)][0],
                          bb[term_b(pr)][1]);
        }
      }
    } else {
      // the steps unrolled: p rounded to bfloat16 in place of the scores
#pragma unroll
      for (int c = 0; c < kTile / 16; ++c) {
        if (16 * c >= ncols) continue;
        const float(&p0)[4] = s[c / 2][2 * (c % 2)];
        const float(&p1)[4] = s[c / 2][2 * (c % 2) + 1];
        const unsigned a[4] = {
            bf16_pair(p0[0], p0[1]), bf16_pair(p0[2], p0[3]),
            bf16_pair(p1[0], p1[1]), bf16_pair(p1[2], p1[3])};
#pragma unroll
        for (int n = 0; n < kTile / 8; n += 2) {
          if (8 * n >= dh16) continue;
          unsigned b0[2], b1[2];
          frag_b2_bf16<LV>(b0, b1, reinterpret_cast<const uint16_t*>(Vs),
                           16 * c, 8 * n);
          mma16816_bf16(o[n], a, b0[0], b0[1]);
          mma16816_bf16(o[n + 1], a, b1[0], b1[1]);
        }
      }
    }
    __syncthreads();                      // every warp is done with V
    if (j + 1 < blocks) load_v(j + 1);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // out = acc / max(l, 1e-30), rounded once to T
  T* ot = out + (((long long)b * H + h) * Sq + q0) * dh;
  const bool pair = dh % 2 == 0;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int row = 16 * warp + g + 8 * h2;
    if (q0 + row >= Sq) continue;
    const float den = fmaxf(l[h2], 1e-30f);
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      const int d = 8 * n + 2 * t;
      if (d >= dh) continue;
      store2(ot + (long long)row * dh + d, __fdiv_rn(o[n][2 * h2], den),
             __fdiv_rn(o[n][2 * h2 + 1], den), d + 1 < dh, pair);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int KvH, int Sq, int Skv, int dh, int bkv, float scale,
           int causal, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        fa_mma<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Smem<T>::kBytes);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int tiles = (Sq + Smem<T>::kRows - 1) / Smem<T>::kRows;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const bool vec = dh * sizeof(T) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const dim3 grid(B * H, tiles);
  fa_mma<T><<<grid, 32 * Cfg<T>::kWarps, Smem<T>::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, KvH, Sq, Skv, dh,
      bkv, scale * 1.4426950408889634f, causal, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, Sq, dh), k and v (B, KvH, Skv, dh), out (B, H, Sq, dh), all
// float32 (bf16 = 0) or all bfloat16 (bf16 = 1), contiguous.  args: B, H,
// KvH, Sq, Skv, dh, bkv (the kv block), causal, bf16; 1 <= dh, bkv <= 128,
// H % KvH == 0.  scale: the scores' factor (dh^-0.5).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, const int* args,
                                   float scale, cudaStream_t stream) {
  const int B = args[0], H = args[1], KvH = args[2], Sq = args[3];
  const int Skv = args[4], dh = args[5], bkv = args[6], causal = args[7];
  const int in_bf16 = args[8];
  if (B < 1 || H < 1 || KvH < 1 || H % KvH || (long long)B * H > 2147483647 ||
      Sq < 1 || Skv < 1 || dh < 1 || dh > kTile || bkv < 1 || bkv > kTile)
    return (int)cudaErrorInvalidValue;
  if (in_bf16)
    return launch<bf16>(q, k, v, out, B, H, KvH, Sq, Skv, dh, bkv, scale,
                        causal, stream);
  return launch<float>(q, k, v, out, B, H, KvH, Sq, Skv, dh, bkv, scale,
                       causal, stream);
}

// the constants the wrapper copies: the largest dh and kv block, and the
// q tile's rows for float32 and for bfloat16 operands
extern "C" void flash_attention_tiles(int* t) {
  constexpr int kRowsF32 = Smem<float>::kRows, kRowsBf16 = Smem<bf16>::kRows;
  t[0] = kTile;
  t[1] = kRowsF32;
  t[2] = kRowsBf16;
}

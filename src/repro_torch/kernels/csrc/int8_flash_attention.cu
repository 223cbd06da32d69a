// Int8-operand flash attention with float softmax statistics, for Hopper
// (sm_90a), on the s8 tensor cores: out (B, H, Sq, dh) float32 or bfloat16
// (q's dtype) from float32 or bfloat16 q (B, H, Sq, dh), k and v (B, KvH,
// Skv, dh), quantized per head inside the launches, and an explicit bool
// mask (B, Sq, Skv).  Query head h reads KV group h / rep.
//
// Replaces: src/repro/kernels/flash_attention.py::int8_flash_attention_fwd
// (pallas_call at flash_attention.py:229) with its _per_head_quantize, the
// TPU kernel with a (B, H, q blocks, kv blocks) grid whose last axis walks
// the kv blocks in order, carrying the running max, denominator and output
// accumulator in VMEM; and this file's first design (fa_int8: one CTA per
// (b, h, q block) on __dp4a, fed int8 payloads that about ten eager torch
// passes per tensor had made).  Per kv block: S = int32(q k^T) * sqk,
// masked to -1e30; m_new = max(m, rowmax S); p = exp(S - m_new); pq =
// round(p * 127) (half to even); corr = exp(m - m_new); l = l * corr +
// sum(pq) / 127; acc = acc * corr + int32(pq v) * (sv / 127); out = acc /
// max(l, 1e-30).  The block structure is part of the function: a kv
// column past Skv inside the last block counts as a masked column with
// v = 0, and a block is exactly bkv columns.
//
// Bound on this card: bytes at the engine's shapes.  A decode step's call
// reads the whole float cache once for one query row per head; the design
// reads it twice (once to take each head's amax, once to quantize and
// use it), the second time mostly from L2.
//
// Design: two launches.
//   * fa_int8_amax: each CTA takes up to kAmaxRows rows of one head of q,
//     k or v (16-byte loads where the strides allow), reduces max |x| and
//     folds it into that head's slot with one integer atomicMax on the
//     bits (non-negative floats order as integers, so the result is exact
//     and order-free).
//   * fa_int8_tc: a thread-block cluster per (b, KV group, tile of up to
//     64 query rows), all rep heads of the group in one tile, so each K
//     and V byte feeds every head.  CTA `rank` of the cluster owns kv
//     block rank (and rank + csize, ... in later rounds of csize blocks).
//     Each CTA quantizes at the load -- scale = max(amax, 1e-9) / 127 and
//     clamp(rint(x / scale), -127, 127), the bytes _per_head_quantize
//     makes -- its Q tile, its K block and its V block, written K-major
//     for the PV product in the same store.  Both products are
//     mma.sync.m16n8k32 s8, transposed: K rows (and for PV the head
//     dimension) are the m16, the query rows the n8, so a decode tile of
//     8 rows is one n8.  The requantized pq of block j depends only on
//     m_j, the prefix max of the blocks' row maxes, so the blocks run at
//     once: every CTA takes its block's row maxes, the cluster shares them
//     through distributed shared memory, each CTA forms m_j, its pq, its
//     row sums of pq and its int32 PV; then, in block order, the running
//     l and acc take exactly the reference's float32 operations, each CTA
//     of the cluster finishing a share of the rows and reading every
//     block's PV from the CTA that made it.  A per-split max
//     (flash-decoding) would change the function; this does not.  The
//     amax workspace is set back to zero by the last CTA to read it.
// Multiplies and adds of the statistics are separately rounded
// (__fmul_rn / __fadd_rn), and rounding is half to even
// (__float2int_rn), never roundf.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtypes.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

constexpr int kTile = 128;        // the largest bkv and dh
constexpr int kMaxRows = 64;      // query rows of a tile
constexpr int kMaxCluster = 8;    // CTAs of a cluster: kv blocks a round
constexpr int kAmaxRows = 64;     // rows of one head an amax CTA reduces
constexpr int kLoads = 4;         // 16-byte loads in flight a thread
constexpr int kLd = kTile + 16;   // bytes a row of the int8 tiles
constexpr int kPvLd = kTile + 4;  // ints a row of the PV block

namespace {

constexpr float kNegInf = -1e30f;

struct FaArgs {
  int B, H, KvH, Sq, Skv, dh, bkv;
  int q_bf16, kv_bf16, q_vec, kv_vec;
  int qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss;   // element strides
  int rows, rtiles, nk, csize, chunks_q, chunks_kv;
  float sm_scale;
};

// the scale of a head from its amax bits, as _per_head_quantize takes it
__device__ __forceinline__ float head_scale(unsigned amax_bits) {
  return __fdiv_rn(fmaxf(__uint_as_float(amax_bits), 1e-9f), 127.f);
}

// element i of a 16-byte piece of 8 bfloat16 / 4 float32 values, or of a
// single value (VEC false) in word 0
template <bool BF16>
__device__ __forceinline__ float elem(const uint4& v, int i) {
  const unsigned w = i / (BF16 ? 2 : 1) == 0   ? v.x
                     : i / (BF16 ? 2 : 1) == 1 ? v.y
                     : i / (BF16 ? 2 : 1) == 2 ? v.z
                                               : v.w;
  return BF16 ? __uint_as_float((i % 2 ? w >> 16 : w & 0xffffu) << 16)
              : __uint_as_float(w);
}

// The N values of a piece as int8 bytes, clamp(rint(x / scale), -127,
// 127), little-endian in words, each x / scale rounded once as the
// reference divides.  No division: with inv = RN(1 / scale), y = RN(x *
// inv) is within 2 ulp of x / scale, the remainder x - scale * y is
// exact in one FMA, and RN(y + remainder * inv) is the correctly rounded
// quotient -- the last step of the hardware's own division, which the
// CPU tests check exactly next to every half-integer, where rint could
// tell them apart.  (A division, inlined at each unrolled value, or even
// called for the rare value near a half-integer, made this launch two to
// four times slower on the card.)  |x| is at most its head's amax, so
// |x / scale| <= 127 and the clamp never bites.
template <bool BF16, int N>
__device__ __forceinline__ uint2 quant_piece(const uint4& v, float scale,
                                             float inv) {
  unsigned w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float x = elem<BF16>(v, i);
    const float y = __fmul_rn(x, inv);
    const float q = __fmaf_rn(__fmaf_rn(-scale, y, x), inv, y);
    w[i / 4] |= ((unsigned)__float2int_rn(q) & 0xffu) << (8 * (i % 4));
  }
  return make_uint2(w[0], w[1]);
}

// A tile of `rows` rows of dh values, row r read from src(r) (nullptr: a
// zero row), quantized with scale(r) = {scale, RN(1 / scale)}, into dst:
// element (r, d) at byte r
// * rs + d * ds.  16-byte loads (VEC) kLoads at a time a thread, so many
// loads are in flight before the first is used.  Row-major (ds == 1) the
// lanes of a warp take neighbouring pieces of a row; transposed (rs == 1)
// neighbouring rows at one piece, so that each byte store of the warp
// falls in one row of dst, in distinct banks.
template <bool BF16, bool VEC, typename Src, typename Scale>
__device__ __forceinline__ void load_q8(uint8_t* dst, int rs, int ds,
                                        int rows, int dh, Src&& src,
                                        Scale&& scale) {
  constexpr int kEs = BF16 ? 2 : 4;
  constexpr int kPer = VEC ? 16 / kEs : 1;   // values a piece
  const int pieces = dh / kPer, total = rows * pieces;
  const bool by_row = ds == 1;
  // piece e: row e / pieces, piece e % pieces (by_row), or row e % rows,
  // piece e / rows; shifts where pieces is a power of two (dh = 128)
  const int sh = (pieces & (pieces - 1)) == 0 ? __ffs(pieces) - 1 : -1;
  auto row_of = [&](int e) {
    return by_row ? (sh >= 0 ? e >> sh : e / pieces) : e % rows;
  };
  auto piece_of = [&](int e) {
    return by_row ? (sh >= 0 ? e & (pieces - 1) : e % pieces) : e / rows;
  };
  for (int e0 = threadIdx.x; e0 < total; e0 += kLoads * kTcThreads) {
    uint4 raw[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * kTcThreads;
      raw[u] = make_uint4(0, 0, 0, 0);
      const char* p = e < total ? src(row_of(e)) : nullptr;
      if (p == nullptr) continue;
      p += piece_of(e) * kPer * kEs;
      if (VEC)
        raw[u] = *reinterpret_cast<const uint4*>(p);
      else
        raw[u].x = BF16 ? *reinterpret_cast<const uint16_t*>(p)
                        : *reinterpret_cast<const unsigned*>(p);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * kTcThreads;
      if (e >= total) break;
      const int r = row_of(e), d0 = piece_of(e) * kPer;
      const float2 sc = scale(r);
      const uint2 b8 = quant_piece<BF16, kPer>(raw[u], sc.x, sc.y);
      uint8_t* o = dst + r * rs + d0 * ds;
      if (by_row && kPer % 4 == 0) {   // whole words along the row
        *reinterpret_cast<unsigned*>(o) = b8.x;
        if (kPer == 8) *reinterpret_cast<unsigned*>(o + 4) = b8.y;
      } else {
#pragma unroll
        for (int i = 0; i < kPer; ++i)
          o[i * ds] = (uint8_t)((i < 4 ? b8.x : b8.y) >> (8 * (i % 4)));
      }
    }
  }
}

template <typename Src, typename Scale>
__device__ __forceinline__ void load_q8(uint8_t* dst, int rs, int ds,
                                        int rows, int dh, bool bf16,
                                        bool vec, Src&& src, Scale&& scale) {
  if (bf16)
    vec ? load_q8<true, true>(dst, rs, ds, rows, dh, src, scale)
        : load_q8<true, false>(dst, rs, ds, rows, dh, src, scale);
  else
    vec ? load_q8<false, true>(dst, rs, ds, rows, dh, src, scale)
        : load_q8<false, false>(dst, rs, ds, rows, dh, src, scale);
}

// max |x| of up to kAmaxRows rows of one head of q, k or v into that
// head's slot of amax: q heads [0, H), k [H, H + KvH), v after them
template <bool BF16, bool VEC>
__device__ __forceinline__ float head_amax(const char* base, int sb, int sh,
                                           int ss, int S, int head, int r0,
                                           int nrows, int dh) {
  constexpr int kEs = BF16 ? 2 : 4;
  constexpr int kPer = VEC ? 16 / kEs : 1;
  const int pieces = dh / kPer, total = nrows * pieces;
  float m = 0.f;
  for (int e0 = threadIdx.x; e0 < total; e0 += 4 * kTcThreads) {
    uint4 raw[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * kTcThreads;
      raw[u] = make_uint4(0, 0, 0, 0);
      if (e >= total) continue;
      const int r = r0 + e / pieces, b = r / S, s = r % S;
      const char* p =
          base + ((long long)b * sb + (long long)head * sh +
                  (long long)s * ss + (e % pieces) * kPer) * kEs;
      if (VEC)
        raw[u] = *reinterpret_cast<const uint4*>(p);
      else
        raw[u].x = BF16 ? *reinterpret_cast<const uint16_t*>(p)
                        : *reinterpret_cast<const unsigned*>(p);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        m = fmaxf(m, fabsf(elem<BF16>(raw[u], i)));
  }
  return m;
}

__global__ void __launch_bounds__(kTcThreads)
fa_int8_amax(const char* __restrict__ q, const char* __restrict__ k,
             const char* __restrict__ v, unsigned* __restrict__ amax,
             const FaArgs a) {
  __shared__ float red[kTcThreads / 32];
  int blk = blockIdx.x, slot, head, chunk, S, sb, sh, ss;
  const char* base;
  bool bf16, vec;
  if (blk < a.H * a.chunks_q) {
    head = blk / a.chunks_q;
    chunk = blk % a.chunks_q;
    slot = head;
    base = q, S = a.Sq, sb = a.qsb, sh = a.qsh, ss = a.qss;
    bf16 = a.q_bf16, vec = a.q_vec;
  } else {
    blk -= a.H * a.chunks_q;
    const int t = blk / (a.KvH * a.chunks_kv), rem = blk % (a.KvH * a.chunks_kv);
    head = rem / a.chunks_kv;
    chunk = rem % a.chunks_kv;
    slot = a.H + t * a.KvH + head;
    base = t ? v : k, S = a.Skv;
    sb = t ? a.vsb : a.ksb, sh = t ? a.vsh : a.ksh, ss = t ? a.vss : a.kss;
    bf16 = a.kv_bf16, vec = a.kv_vec;
  }
  const int r0 = chunk * kAmaxRows;
  const int nrows = min(kAmaxRows, a.B * S - r0);
  float m;
  if (bf16)
    m = vec ? head_amax<true, true>(base, sb, sh, ss, S, head, r0, nrows,
                                    a.dh)
            : head_amax<true, false>(base, sb, sh, ss, S, head, r0, nrows,
                                     a.dh);
  else
    m = vec ? head_amax<false, true>(base, sb, sh, ss, S, head, r0, nrows,
                                     a.dh)
            : head_amax<false, false>(base, sb, sh, ss, S, head, r0, nrows,
                                      a.dh);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kTcThreads / 32; ++w) m = fmaxf(m, red[w]);
    atomicMax(amax + slot, __float_as_uint(m));
  }
}

// shared memory of the attention CTA, in bytes from its base
struct FaSmem {
  int qs, ks, vt, ps, pv, wmax, bmax, lsum, mrun, lrun, scq, sqk, rowh,
      rowt, mj, corr, accs, total;   // (the float arrays 16-byte aligned)
  __host__ __device__ FaSmem(int R, int csize) {
    const int rm = (R + csize - 1) / csize;   // rows a CTA finishes
    int o = 0;
    qs = o, o += R * kLd;
    ks = o, o += kTile * kLd;
    vt = o, o += kTile * kLd;
    ps = o, o += R * kLd;
    pv = o, o += R * kPvLd * 4;
    wmax = o, o += 8 * R * 4;
    bmax = o, o += R * 4;
    lsum = o, o += R * 4;
    mrun = o, o += R * 4;
    lrun = o, o += R * 4;
    scq = o, o += (R + 2) * 8;   // {scale, 1 / scale} a row; k's, v's
    sqk = o, o += R * 4;
    rowh = o, o += R * 4;
    rowt = o, o += R * 4;
    mj = o, o += (kMaxCluster + 1) * R * 4;
    corr = o, o += kMaxCluster * rm * 4;
    o = (o + 15) / 16 * 16;
    accs = o, o += rm * kTile * 4;
    total = o;
  }
};

// grid (csize, rtiles * KvH, B), clusters of (csize, 1, 1).  Tile row i
// of tile rt is query row gi = rt * R + i of the group: head g * rep + gi
// / Sq, position gi % Sq.
template <int NT>
__global__ void __launch_bounds__(kTcThreads)
fa_int8_tc(const char* __restrict__ q, const char* __restrict__ k,
           const char* __restrict__ v, const uint8_t* __restrict__ mask,
           unsigned* __restrict__ ws, void* __restrict__ out, const FaArgs a) {
  constexpr int R = 8 * NT;
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), C = a.csize;
  const FaSmem L(R, C);
  uint8_t* Qs = smem + L.qs;
  uint8_t* Ks = smem + L.ks;
  uint8_t* Vt = smem + L.vt;
  uint8_t* Ps = smem + L.ps;
  int* pv = reinterpret_cast<int*>(smem + L.pv);
  float* wmax = reinterpret_cast<float*>(smem + L.wmax);
  float* bmax = reinterpret_cast<float*>(smem + L.bmax);
  int* lsum = reinterpret_cast<int*>(smem + L.lsum);
  float* mrun = reinterpret_cast<float*>(smem + L.mrun);
  float* lrun = reinterpret_cast<float*>(smem + L.lrun);
  float2* scq = reinterpret_cast<float2*>(smem + L.scq);
  float* sqk = reinterpret_cast<float*>(smem + L.sqk);
  int* rowh = reinterpret_cast<int*>(smem + L.rowh);
  int* rowt = reinterpret_cast<int*>(smem + L.rowt);
  float* mj = reinterpret_cast<float*>(smem + L.mj);
  float* corr = reinterpret_cast<float*>(smem + L.corr);
  float* accs = reinterpret_cast<float*>(smem + L.accs);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.z, g = blockIdx.y % a.KvH, rt = blockIdx.y / a.KvH;
  const int rep = a.H / a.KvH, dh = a.dh;
  const int DH = (dh + 31) / 32 * 32;   // dh in whole k32 steps
  const int nscales = a.H + 2 * a.KvH;
  // the scales this CTA uses, each row's q scale, then k's and v's, land
  // in shared memory before the CTA counts itself done with the amax slots
  if (tid < R) {
    const int gi = rt * R + tid;
    const bool valid = gi < a.rows;
    const int h = g * rep + (valid ? gi / a.Sq : 0);
    rowh[tid] = h;
    rowt[tid] = valid ? gi % a.Sq : -1;
    const float sc = head_scale(ws[h]);
    scq[tid] = make_float2(sc, __frcp_rn(sc));
    mrun[tid] = kNegInf;
    lrun[tid] = 0.f;
  } else if (tid < R + 2) {
    const float sc = head_scale(ws[a.H + (tid - R) * a.KvH + g]);
    scq[tid] = make_float2(sc, __frcp_rn(sc));
  }
  for (int e = tid; e < R * kLd / 16; e += kTcThreads)
    reinterpret_cast<uint4*>(Qs)[e] = make_uint4(0, 0, 0, 0);
  for (int e = tid; e < kTile * kLd / 16; e += kTcThreads)
    reinterpret_cast<uint4*>(Ks)[e] = make_uint4(0, 0, 0, 0);
  for (int e = tid; e < ((R + C - 1) / C) * kTile; e += kTcThreads)
    accs[e] = 0.f;
  __syncthreads();   // the scales are read; the tiles are zero
  // this CTA is done with the amax slots: count it now, and let the last
  // CTA to count clear them at its end (the count's reply is awaited
  // there, not here)
  unsigned* counter = ws + nscales;
  const unsigned counted = tid == 0 ? atomicAdd(counter, 1u) : 0u;
  const float2 sk = scq[R], sv = scq[R + 1];
  const float s_v = __fdiv_rn(sv.x, 127.f);
  if (tid < R) sqk[tid] = __fmul_rn(__fmul_rn(scq[tid].x, sk.x), a.sm_scale);
  // the Q tile, each row quantized with its head's scale
  load_q8(
      Qs, kLd, 1, R, dh, a.q_bf16, a.q_vec,
      [&](int i) -> const char* {
        if (rowt[i] < 0) return nullptr;
        return q + ((long long)b * a.qsb + (long long)rowh[i] * a.qsh +
                    (long long)rowt[i] * a.qss) * (a.q_bf16 ? 2 : 4);
      },
      [&](int i) { return scq[i]; });
  const int es_kv = a.kv_bf16 ? 2 : 4;
  const uint8_t* mb = mask + (long long)b * a.Sq * a.Skv;
  const int nround = (a.nk + C - 1) / C;

  for (int rd = 0; rd < nround; ++rd) {
    const int j = rd * C + rank, kv0 = j * a.bkv;
    const bool own = j < a.nk;
    float s[NT][4];
    if (own) {
      auto kv_row = [&](const char* base, int sb, int sh, int ss) {
        return [=](int c) -> const char* {
          const int kv = kv0 + c;
          if (c >= a.bkv || kv >= a.Skv) return nullptr;
          return base + ((long long)b * sb + (long long)g * sh +
                         (long long)kv * ss) * es_kv;
        };
      };
      load_q8(Ks, kLd, 1, kTile, dh, a.kv_bf16, a.kv_vec,
              kv_row(k, a.ksb, a.ksh, a.kss), [&](int) { return sk; });
      load_q8(Vt, 1, kLd, kTile, dh, a.kv_bf16, a.kv_vec,
              kv_row(v, a.vsb, a.vsh, a.vss), [&](int) { return sv; });
      if (tid < R) lsum[tid] = 0;
      __syncthreads();   // Q, K and V are quantized

      // S^T = K Q^T: warp w takes kv rows 16 w .. 16 w + 15 of the block
      int sacc[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[n][e] = 0;
      for (int kk = 0; kk < DH; kk += 32) {
        unsigned af[4];
        ldsm_x4(af, Ks + (16 * warp + lane % 16) * kLd + kk + 16 * (lane / 16));
        if constexpr (NT == 1) {
          unsigned bq[2];
          ldsm_x2(bq, Qs + (lane % 8) * kLd + kk + 16 * ((lane / 8) % 2));
          mma16832_s8(sacc[0], af, bq[0], bq[1]);
        } else {
#pragma unroll
          for (int n = 0; n < NT; n += 2) {
            unsigned r[4];
            ldsm_x4(r, Qs + (8 * n + lane % 8 + 8 * (lane / 16)) * kLd + kk +
                           16 * ((lane / 8) % 2));
            mma16832_s8(sacc[n], af, r[0], r[1]);
            mma16832_s8(sacc[n + 1], af, r[2], r[3]);
          }
        }
      }
      // scale and mask; a column past bkv is no column of the block
      // (-inf: it takes no part in the max and its pq is 0)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 16 * warp + lane / 4 + 8 * (e / 2);
          const int i = 8 * n + 2 * (lane % 4) + e % 2, kv = kv0 + c;
          const int t = rowt[i];
          const bool live = kv < a.Skv && t >= 0 &&
                            mb[(long long)t * a.Skv + kv] != 0;
          s[n][e] = c >= a.bkv ? -INFINITY
                    : live     ? __fmul_rn(__int2float_rn(sacc[n][e]), sqk[i])
                               : kNegInf;
        }
      // the block's row maxes: over the warp's 16 kv, then over the warps
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float m = fmaxf(s[n][h], s[n][h + 2]);
#pragma unroll
          for (int o = 4; o < 32; o <<= 1)
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
          if (lane < 4) wmax[warp * R + 8 * n + 2 * lane + h] = m;
        }
      __syncthreads();
      if (tid < R) {
        float m = wmax[tid];
        for (int w = 1; w < kTcThreads / 32; ++w)
          m = fmaxf(m, wmax[w * R + tid]);
        bmax[tid] = m;
      }
    }
    cl.sync();   // every block's row maxes are in its CTA

    // m_j through the round, from every CTA's row maxes: mj[jj][i] is the
    // running max before block rd * C + jj, mj[jj + 1][i] after it
    if (tid < R) {
      float m = mrun[tid];
      mj[tid] = m;
      for (int jj = 0; jj < C; ++jj) {
        if (rd * C + jj < a.nk)
          m = fmaxf(m, cl.map_shared_rank(bmax, jj)[tid]);
        mj[(jj + 1) * R + tid] = m;
      }
      mrun[tid] = m;
    }
    __syncthreads();

    if (own) {
      // pq = round(exp(s - m_j) * 127) into Ps (row, kv); its row sums
      const float* m_j = mj + (rank + 1) * R;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 8 * n + 2 * (lane % 4) + h;
          int sum = 0;
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int e = h + 2 * hi;
            const int c = 16 * warp + lane / 4 + 8 * hi;
            int pq = 0;
            if (c < a.bkv)
              pq = __float2int_rn(
                  __fmul_rn(expf(__fsub_rn(s[n][e], m_j[i])), 127.f));
            Ps[i * kLd + c] = (uint8_t)pq;
            sum += pq;
          }
#pragma unroll
          for (int o = 4; o < 32; o <<= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, o);
          if (lane < 4) atomicAdd(lsum + 8 * n + 2 * lane + h, sum);
        }
      __syncthreads();   // Ps is whole

      // PV^T = V^T P^T: warp w takes head dims 16 w .. 16 w + 15
      if (16 * warp < DH) {
        int pacc[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) pacc[n][e] = 0;
        const int KB = (a.bkv + 31) / 32 * 32;
        for (int kk = 0; kk < KB; kk += 32) {
          unsigned af[4];
          ldsm_x4(af, Vt + (16 * warp + lane % 16) * kLd + kk + 16 * (lane / 16));
          if constexpr (NT == 1) {
            unsigned bp[2];
            ldsm_x2(bp, Ps + (lane % 8) * kLd + kk + 16 * ((lane / 8) % 2));
            mma16832_s8(pacc[0], af, bp[0], bp[1]);
          } else {
#pragma unroll
            for (int n = 0; n < NT; n += 2) {
              unsigned r[4];
              ldsm_x4(r, Ps + (8 * n + lane % 8 + 8 * (lane / 16)) * kLd +
                             kk + 16 * ((lane / 8) % 2));
              mma16832_s8(pacc[n], af, r[0], r[1]);
              mma16832_s8(pacc[n + 1], af, r[2], r[3]);
            }
          }
        }
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = 16 * warp + lane / 4 + 8 * (e / 2);
            const int i = 8 * n + 2 * (lane % 4) + e % 2;
            pv[i * kPvLd + d] = pacc[n][e];
          }
      }
    }
    cl.sync();   // every block's pq row sums and PV are in its CTA

    // in block order, the reference's float32 chain for this CTA's rows
    // (i = rank, rank + C, ...): l and the correction factors first
    // (every block's values are loaded before the chain uses them, so the
    // reads of the other CTAs' shared memory are in flight together)
    const int rm = (R - rank + C - 1) / C;   // rows this CTA finishes
    const int nb = min(C, a.nk - rd * C);    // blocks of this round
    if (tid < rm) {
      const int i = rank + C * tid;
      int ps[kMaxCluster];
#pragma unroll
      for (int jj = 0; jj < kMaxCluster; ++jj)
        if (jj < nb) ps[jj] = cl.map_shared_rank(lsum, jj)[i];
      float l = lrun[i];
#pragma unroll
      for (int jj = 0; jj < kMaxCluster; ++jj) {
        if (jj >= nb) break;
        const float cr = expf(__fsub_rn(mj[jj * R + i], mj[(jj + 1) * R + i]));
        l = __fadd_rn(__fmul_rn(l, cr),
                      __fdiv_rn(__int2float_rn(ps[jj]), 127.f));
        corr[jj * ((R + C - 1) / C) + tid] = cr;
      }
      lrun[i] = l;
    }
    __syncthreads();
    const bool last = rd == nround - 1;
    // four head dims a thread (16-byte reads; dh % 4 == 0)
    const int dq = dh / 4;
    for (int e = tid; e < rm * dq; e += kTcThreads) {
      const int il = e / dq, d = 4 * (e % dq), i = rank + C * il;
      int4 p[kMaxCluster];
#pragma unroll
      for (int jj = 0; jj < kMaxCluster; ++jj)
        if (jj < nb)
          p[jj] = *reinterpret_cast<const int4*>(
              cl.map_shared_rank(pv, jj) + i * kPvLd + d);
      float4 acc = *reinterpret_cast<const float4*>(accs + il * kTile + d);
      float* av = reinterpret_cast<float*>(&acc);
#pragma unroll
      for (int jj = 0; jj < kMaxCluster; ++jj) {
        if (jj >= nb) break;
        const float cr = corr[jj * ((R + C - 1) / C) + il];
        const int* pj = reinterpret_cast<const int*>(&p[jj]);
#pragma unroll
        for (int t = 0; t < 4; ++t)
          av[t] = __fadd_rn(__fmul_rn(av[t], cr),
                            __fmul_rn(__int2float_rn(pj[t]), s_v));
      }
      *reinterpret_cast<float4*>(accs + il * kTile + d) = acc;
      if (last && rowt[i] >= 0) {
        const float den = fmaxf(lrun[i], 1e-30f);
        const long long at =
            (((long long)b * a.H + rowh[i]) * a.Sq + rowt[i]) * dh + d;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float o = __fdiv_rn(av[t], den);
          if (a.q_bf16)
            static_cast<bf16*>(out)[at + t] = __float2bfloat16_rn(o);
          else
            static_cast<float*>(out)[at + t] = o;
        }
      }
    }
    cl.sync();   // no CTA reads another's shared memory after this
  }
  if (tid == 0 && counted == gridDim.x * gridDim.y * gridDim.z - 1) {
    for (int i = 0; i < nscales; ++i) ws[i] = 0u;
    *counter = 0u;
  }
}

template <int NT>
int launch_tc(const char* q, const char* k, const char* v,
              const uint8_t* mask, unsigned* ws, void* out, const FaArgs& a,
              cudaStream_t stream) {
  const int smem = FaSmem(8 * NT, a.csize).total;
  static int attr = 0;
  if (smem > attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        fa_int8_tc<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attr = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.csize, a.rtiles * a.KvH, a.B);
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = a.csize;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, fa_int8_tc<NT>, q, k, v, mask, ws,
                                 out, a);
}

// The launch pair's arguments from the C entry's ints (see below); false
// where they are out of the kernels' range.
bool fa_args(FaArgs& a, int& R, const void* q, const void* k, const void* v,
             const int* args, float sm_scale) {
  a = FaArgs{};
  a.B = args[0], a.H = args[1], a.KvH = args[2], a.Sq = args[3];
  a.Skv = args[4], a.dh = args[5], a.bkv = args[6];
  a.q_bf16 = args[7], a.kv_bf16 = args[8];
  a.qsb = args[9], a.qsh = args[10], a.qss = args[11];
  a.ksb = args[12], a.ksh = args[13], a.kss = args[14];
  a.vsb = args[15], a.vsh = args[16], a.vss = args[17];
  R = args[18];
  if (a.B < 1 || a.H < 1 || a.KvH < 1 || a.H % a.KvH || a.Sq < 1 ||
      a.Skv < 1 || a.dh < 4 || a.dh % 4 || a.dh > kTile || a.bkv < 1 ||
      a.bkv > kTile || (R != 8 && R != 16 && R != 32 && R != kMaxRows) ||
      a.B > 65535)
    return false;
  a.rows = a.H / a.KvH * a.Sq;
  a.rtiles = (a.rows + R - 1) / R;
  a.nk = (a.Skv + a.bkv - 1) / a.bkv;
  a.csize = a.nk < kMaxCluster ? a.nk : kMaxCluster;
  a.chunks_q = (a.B * a.Sq + kAmaxRows - 1) / kAmaxRows;
  a.chunks_kv = (a.B * a.Skv + kAmaxRows - 1) / kAmaxRows;
  a.sm_scale = sm_scale;
  auto aligned = [](const void* p, int es, int sb, int sh, int ss, int dh) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
           (long long)sb * es % 16 == 0 && (long long)sh * es % 16 == 0 &&
           (long long)ss * es % 16 == 0 && dh * es % 16 == 0;
  };
  const int qes = a.q_bf16 ? 2 : 4, kves = a.kv_bf16 ? 2 : 4;
  a.q_vec = aligned(q, qes, a.qsb, a.qsh, a.qss, a.dh);
  a.kv_vec = aligned(k, kves, a.ksb, a.ksh, a.kss, a.dh) &&
             aligned(v, kves, a.vsb, a.vsh, a.vss, a.dh);
  return (long long)a.rtiles * a.KvH <= 65535;
}

int launch_amax(const FaArgs& a, const void* q, const void* k,
                const void* v, unsigned* ws, cudaStream_t stream) {
  const int ctas = a.H * a.chunks_q + 2 * a.KvH * a.chunks_kv;
  fa_int8_amax<<<ctas, kTcThreads, 0, stream>>>(
      static_cast<const char*>(q), static_cast<const char*>(k),
      static_cast<const char*>(v), ws, a);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, Sq, dh), k and v (B, KvH, Skv, dh) float32 or bfloat16 (flags
// q_bf16, kv_bf16), each with its own element strides over (b, head, s)
// and d contiguous; mask (B, Sq, Skv) one byte per entry (0 = masked),
// contiguous; ws (H + 2 KvH + 1) 32-bit words, zero (the amax slots and
// the counter; the launch pair leaves them zero); out (B, H, Sq, dh)
// contiguous, q's dtype.  args holds the 19 ints {B, H, KvH, Sq, Skv, dh,
// bkv, q_bf16, kv_bf16, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, R
// (query rows a tile: 8, 16, 32 or 64)}; H % KvH == 0, dh % 4 == 0, dh
// <= 128, 1 <= bkv <= 128.  sm_scale multiplies sq * sk[g] in float32.
extern "C" int int8_flash_attention(const void* q, const void* k,
                                    const void* v, const uint8_t* mask,
                                    unsigned* ws, void* out, const int* args,
                                    float sm_scale, cudaStream_t stream) {
  FaArgs a;
  int R;
  if (!fa_args(a, R, q, k, v, args, sm_scale))
    return (int)cudaErrorInvalidValue;
  const int err = launch_amax(a, q, k, v, ws, stream);
  if (err != 0) return err;
  const char* qc = static_cast<const char*>(q);
  const char* kc = static_cast<const char*>(k);
  const char* vc = static_cast<const char*>(v);
  switch (R) {
    case 8: return launch_tc<1>(qc, kc, vc, mask, ws, out, a, stream);
    case 16: return launch_tc<2>(qc, kc, vc, mask, ws, out, a, stream);
    case 32: return launch_tc<4>(qc, kc, vc, mask, ws, out, a, stream);
  }
  return launch_tc<8>(qc, kc, vc, mask, ws, out, a, stream);
}

// The first launch alone: the bits of max |x| of each head of q, k and v
// folded into ws's H + 2 KvH slots (zero before), which it leaves as they
// are -- what the attention launch reads.  The arguments are
// int8_flash_attention's.
extern "C" int int8_flash_attention_amax(const void* q, const void* k,
                                         const void* v, unsigned* ws,
                                         const int* args,
                                         cudaStream_t stream) {
  FaArgs a;
  int R;
  if (!fa_args(a, R, q, k, v, args, 1.f)) return (int)cudaErrorInvalidValue;
  return launch_amax(a, q, k, v, ws, stream);
}

// The constants the wrapper sizes its tiles by, for it to check once at
// load: the largest bkv and dh, query rows a tile, CTAs a cluster.
extern "C" void int8_flash_attention_tiles(int* t) {
  t[0] = kTile;
  t[1] = kMaxRows;
  t[2] = kMaxCluster;
}

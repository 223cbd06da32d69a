// Int8-operand flash attention with float softmax statistics, for Hopper
// (sm_90a), on the CUDA cores: out (B, H, Sq, dh) float32 from per-head
// int8 q (B, H, Sq, dh), k and v (B, KvH, Skv, dh), an explicit bool mask
// (B, Sq, Skv), the combined score scales sqk (H,) = sq * sk[h / rep] *
// sm_scale and the value scales sv (KvH,).  Query head h reads KV group
// h / rep.
//
// Replaces: src/repro/kernels/flash_attention.py::int8_flash_attention_fwd
// (pallas_call at flash_attention.py:229), the TPU kernel with a (B, H, q
// blocks, kv blocks) grid whose last axis walks the kv blocks in order,
// carrying the running max, denominator and output accumulator in VMEM.
// Per kv block: S = int32(q k^T) * sqk, masked to -1e30; m_new = max(m,
// rowmax S); p = exp(S - m_new); pq = round(p * 127) (half to even); corr
// = exp(m - m_new); l = l * corr + sum(pq) / 127; acc = acc * corr +
// int32(pq v) * (sv / 127); out = acc / max(l, 1e-30).  The requantized
// p depends on the running max at that block, so the block structure is
// part of the function: this kernel walks the same blocks (bq, bkv <= 128),
// and a kv column past Skv inside the last block counts as the
// reference's zero-padded, masked column (S = -1e30, v = 0).
//
// Bound on this card: bytes at the engine's shapes.  Decode reads the whole
// int8 cache for one query row per head; even a prefill chunk of 16 rows
// does 2 * 16 * rep operations per K/V byte (256 at Yi-9B's 8 query heads
// per KV head), below the int8 rate's 590 per byte of HBM bandwidth.
//
// Design: one CTA of 256 threads (16 x 16) per (b, h, q block).  The int8 Q
// block stays in shared memory as int32 words of 4 consecutive d; each kv
// block's K (words along d) and V (words of 4 consecutive kv rows per
// column d) are staged next to it.  Each thread owns rows ty + 16 r and
// columns tx + 16 c of both the score block and the output block, so the
// row statistics it needs live in its own registers; row max and row sum
// reduce over the 16 lanes of a half warp with shuffles (max and integer
// sums, exact in any order).  QK^T and PV are __dp4a (int8 x int8 ->
// int32).  The quantized P goes through shared memory as bytes, read back
// as words of 4 consecutive kv.  Multiplies and adds of the statistics are
// separately rounded (__fmul_rn / __fadd_rn), as the reference's are, and
// rounding is rintf, never roundf.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kTile = 128;     // max bq, bkv and dh
constexpr int kT = kTile / 16; // rows / columns per thread
constexpr float kNegInf = -1e30f;
constexpr size_t kSmem = 4 * sizeof(int) * (size_t)(kTile / 4) * kTile;

__global__ void __launch_bounds__(kThreads)
fa_int8(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
        const int8_t* __restrict__ v, const uint8_t* __restrict__ mask,
        const float* __restrict__ sqk, const float* __restrict__ sv,
        float* __restrict__ out, int H, int KvH, int Sq, int Skv, int dh,
        int bq, int bkv) {
  extern __shared__ int smem[];
  int* Qw = smem;                     // Qw[w * kTile + row]: q[row][4w..4w+3]
  int* Kw = Qw + (kTile / 4) * kTile; // Kw[w * kTile + col]: k[col][4w..]
  int* Vw = Kw + (kTile / 4) * kTile; // Vw[j * kTile + d]: v[4j..4j+3][d]
  int8_t* Pb = reinterpret_cast<int8_t*>(Vw + (kTile / 4) * kTile);
                                      // Pb[row * kTile + col]: pq bytes
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KvH);
  const int q0 = qb * bq, dw = dh / 4, rtiles = (bq + 15) / 16;
  const int nk = (Skv + bkv - 1) / bkv;
  const float s_qk = sqk[h], s_v = sv[g] / 127.f;
  const int8_t* qh = q + ((long long)b * H + h) * Sq * dh;
  const int8_t* kg = k + ((long long)b * KvH + g) * Skv * dh;
  const int8_t* vg = v + ((long long)b * KvH + g) * Skv * dh;
  const uint8_t* mb = mask + (long long)b * Sq * Skv;

  for (int e = tid; e < (kTile / 4) * kTile; e += kThreads) {
    const int w = e / kTile, r = e % kTile;
    Qw[e] = (w < dw && r < bq && q0 + r < Sq)
                ? reinterpret_cast<const int*>(qh + (long long)(q0 + r) * dh)[w]
                : 0;
  }

  float m[kT], l[kT], acc[kT][kT];
#pragma unroll
  for (int r = 0; r < kT; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kT; ++c) acc[r][c] = 0.f;
  }

  for (int j = 0; j < nk; ++j) {
    const int kv0 = j * bkv;
    __syncthreads();  // the previous block is done with Kw, Vw and Pb
    for (int e = tid; e < (kTile / 4) * kTile; e += kThreads) {
      const int w = e / kTile, c = e % kTile;
      Kw[e] = (w < dw && c < bkv && kv0 + c < Skv)
                  ? reinterpret_cast<const int*>(kg + (long long)(kv0 + c) * dh)[w]
                  : 0;
    }
    for (int e = tid; e < (kTile / 4) * kTile; e += kThreads) {
      const int jj = e / kTile, d = e % kTile;
      unsigned u = 0;
      if (d < dh)
        for (int i = 0; i < 4; ++i) {
          const int kv = 4 * jj + i;
          if (kv < bkv && kv0 + kv < Skv)
            u |= (unsigned)(uint8_t)vg[(long long)(kv0 + kv) * dh + d] << (8 * i);
        }
      Vw[e] = (int)u;
    }
    __syncthreads();

    // S = q k^T on this block, scaled and masked
    float s[kT][kT];
#pragma unroll
    for (int r = 0; r < kT; ++r) {
      if (r >= rtiles) continue;
      const int row = ty + 16 * r;
      int sacc[kT];
#pragma unroll
      for (int c = 0; c < kT; ++c) sacc[c] = 0;
      for (int w = 0; w < dw; ++w) {
        const int qv = Qw[w * kTile + row];
#pragma unroll
        for (int c = 0; c < kT; ++c)
          sacc[c] = __dp4a(qv, Kw[w * kTile + tx + 16 * c], sacc[c]);
      }
      const bool row_in = q0 + row < Sq;
#pragma unroll
      for (int c = 0; c < kT; ++c) {
        const int col = tx + 16 * c, kv = kv0 + col;
        const bool live = row_in && kv < Skv &&
                          mb[(long long)(q0 + row) * Skv + kv] != 0;
        s[r][c] = live ? __fmul_rn(__int2float_rn(sacc[c]), s_qk) : kNegInf;
      }
    }

    // online softmax; p requantized to int8 for PV
    float corr[kT];
#pragma unroll
    for (int r = 0; r < kT; ++r) {
      if (r >= rtiles) continue;
      const int row = ty + 16 * r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kT; ++c)
        if (tx + 16 * c < bkv) mx = fmaxf(mx, s[r][c]);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      int psum = 0;
#pragma unroll
      for (int c = 0; c < kT; ++c) {
        const int col = tx + 16 * c;
        int pq = 0;
        if (col < bkv) {
          const float p = expf(__fsub_rn(s[r][c], m_new));
          pq = __float2int_rn(__fmul_rn(p, 127.f));
        }
        psum += pq;
        Pb[row * kTile + col] = (int8_t)pq;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      corr[r] = expf(__fsub_rn(m[r], m_new));
      l[r] = __fadd_rn(__fmul_rn(l[r], corr[r]),
                       __fdiv_rn(__int2float_rn(psum), 127.f));
      m[r] = m_new;
    }
    __syncthreads();

    // acc = acc * corr + int32(pq v) * sv / 127
    const int pw = (bkv + 3) / 4;
#pragma unroll
    for (int r = 0; r < kT; ++r) {
      if (r >= rtiles) continue;
      const int row = ty + 16 * r;
      int pv[kT];
#pragma unroll
      for (int c = 0; c < kT; ++c) pv[c] = 0;
      for (int w = 0; w < pw; ++w) {
        const int pword = reinterpret_cast<const int*>(Pb + row * kTile)[w];
#pragma unroll
        for (int c = 0; c < kT; ++c)
          pv[c] = __dp4a(pword, Vw[w * kTile + tx + 16 * c], pv[c]);
      }
#pragma unroll
      for (int c = 0; c < kT; ++c)
        acc[r][c] = __fadd_rn(__fmul_rn(acc[r][c], corr[r]),
                              __fmul_rn(__int2float_rn(pv[c]), s_v));
    }
  }

  float* oh = out + ((long long)b * H + h) * Sq * dh;
#pragma unroll
  for (int r = 0; r < kT; ++r) {
    const int row = ty + 16 * r;
    if (r >= rtiles || row >= bq || q0 + row >= Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < kT; ++c) {
      const int d = tx + 16 * c;
      if (d < dh)
        oh[(long long)(q0 + row) * dh + d] = __fdiv_rn(acc[r][c], den);
    }
  }
}

}  // namespace

// q (B, H, Sq, dh), k and v (B, KvH, Skv, dh) int8; mask (B, Sq, Skv) one
// byte per entry (0 = masked); sqk (H,) and sv (KvH,) float32; out
// (B, H, Sq, dh) float32; all contiguous.  dh % 4 == 0, dh <= 128,
// 1 <= bq, bkv <= 128, H % KvH == 0.
extern "C" int int8_flash_attention(const int8_t* q, const int8_t* k,
                                    const int8_t* v, const uint8_t* mask,
                                    const float* sqk, const float* sv,
                                    float* out, int B, int H, int KvH, int Sq,
                                    int Skv, int dh, int bq, int bkv,
                                    cudaStream_t stream) {
  if (B < 1 || H < 1 || KvH < 1 || H % KvH || Sq < 1 || Skv < 1 ||
      dh < 4 || dh % 4 || dh > kTile || bq < 1 || bq > kTile || bkv < 1 ||
      bkv > kTile)
    return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        fa_int8, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const dim3 grid((Sq + bq - 1) / bq, H, B);
  fa_int8<<<grid, kThreads, kSmem, stream>>>(q, k, v, mask, sqk, sv, out, H,
                                             KvH, Sq, Skv, dh, bq, bkv);
  return (int)cudaGetLastError();
}

// Float flash attention (forward), for Hopper (sm_90a), on the CUDA cores:
// out (B, H, Sq, dh) float32 from q (B, H, Sq, dh) and k, v (B, KvH, Skv,
// dh), float32 or bfloat16 (one type for all three).  Query head h reads
// KV group h / rep.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_fwd
// (pallas_call at flash_attention.py:99), the TPU kernel with a (B, H,
// q blocks, kv blocks) grid whose last axis walks the kv blocks in order,
// carrying the running max, denominator and output accumulator in VMEM.
// Per kv block: s = (q k^T) * dh^-0.5 with f32 accumulation, masked to
// -1e30 where k_idx >= Skv or (causal) k_idx > q_idx; m_new = max(m,
// rowmax s); p = exp(s - m_new); corr = exp(m - m_new); l = l * corr +
// rowsum p; acc = acc * corr + p.astype(v.dtype) @ v (f32 accumulation);
// out = acc / max(l, 1e-30).  For bfloat16 operands p is rounded to
// bfloat16 before PV against the running max of its block, so the block
// structure is part of the function: this kernel walks the same blocks
// (bq, bkv <= 128), and masked blocks are computed, as in the reference.
//
// Bound on this card: operations at Yi-9B's prefill shapes (Sq = Skv =
// 512, dh = 128: 2 * 512 FLOP per K/V value read, above the fp32 rate's ~20
// FLOP per HBM byte), run here as fp32 FMA on the CUDA cores (no tensor
// cores: a bf16 mma / wgmma version is later work).
//
// Design: one CTA of 256 threads (16 x 16) per (b, h, q block).  The q
// block stays in shared memory as float32 (transposed: Qs[d][row]); each kv
// block's K (Ks[d][col]) and then its V (Vs[j][d]) pass through one buffer,
// and p goes through shared memory (Ps[j][row]).  Each thread owns rows
// ty + 16 r and columns tx + 16 c of the score block and of the output
// block, so the row statistics it needs live in its own registers; row max
// and row sum reduce over the 16 lanes of a half warp with shuffles.
// bfloat16 operands are widened to float32 as they are stored (exact).
// Shared memory: 3 * 128 * 129 * 4 bytes = 198 KB (dynamic, opted in).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kTile = 128;      // max bq, bkv and dh
constexpr int kLd = kTile + 1;  // padded leading dimension
constexpr int kT = kTile / 16;  // rows / columns per thread
constexpr float kNegInf = -1e30f;
constexpr size_t kSmem = 3 * sizeof(float) * (size_t)kTile * kLd;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fa_fwd(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, float* __restrict__ out, int H, int KvH,
       int Sq, int Skv, int dh, int bq, int bkv, float scale, int causal,
       int p_bf16) {
  extern __shared__ float smem[];
  float* Qs = smem;                // Qs[d * kLd + row]
  float* KVs = Qs + kTile * kLd;   // Ks[d * kLd + col], then Vs[j * kLd + d]
  float* Ps = KVs + kTile * kLd;   // Ps[j * kLd + row]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KvH);
  const int q0 = qb * bq, rtiles = (bq + 15) / 16;
  const int nk = (Skv + bkv - 1) / bkv;
  const T* qh = q + ((long long)b * H + h) * Sq * dh;
  const T* kg = k + ((long long)b * KvH + g) * Skv * dh;
  const T* vg = v + ((long long)b * KvH + g) * Skv * dh;

  // the q block, zero past bq and Sq (the reference's zero padding)
  for (int e = tid; e < kTile * dh; e += kThreads) {
    const int r = e / dh, d = e % dh;
    Qs[d * kLd + r] = r < bq && q0 + r < Sq
                          ? widen(qh[(long long)(q0 + r) * dh + d]) : 0.f;
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
    __syncthreads();  // the previous block is done with KVs and Ps
    for (int e = tid; e < kTile * dh; e += kThreads) {
      const int c = e / dh, d = e % dh;
      KVs[d * kLd + c] = c < bkv && kv0 + c < Skv
                             ? widen(kg[(long long)(kv0 + c) * dh + d]) : 0.f;
    }
    __syncthreads();

    // s = (q k^T) * scale on this block, masked; per d, 8 q and 8 k
    // values from shared memory feed 64 FMAs
    float s[kT][kT];
#pragma unroll
    for (int r = 0; r < kT; ++r)
#pragma unroll
      for (int c = 0; c < kT; ++c) s[r][c] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float qv[kT], kv[kT];
#pragma unroll
      for (int r = 0; r < kT; ++r) qv[r] = Qs[d * kLd + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < kT; ++c) kv[c] = KVs[d * kLd + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < kT; ++r)
#pragma unroll
        for (int c = 0; c < kT; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }
#pragma unroll
    for (int r = 0; r < kT; ++r) {
      const int qi = q0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < kT; ++c) {
        const int kv = kv0 + tx + 16 * c;
        const bool live = kv < Skv && (!causal || kv <= qi);
        s[r][c] = live ? __fmul_rn(s[r][c], scale) : kNegInf;
      }
    }

    // online softmax statistics; p to shared memory for PV
    float corr[kT];
#pragma unroll
    for (int r = 0; r < kT; ++r) {
      corr[r] = 1.f;
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
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < kT; ++c) {
        const int col = tx + 16 * c;
        if (col >= bkv) continue;
        const float p = expf(__fsub_rn(s[r][c], m_new));
        psum = __fadd_rn(psum, p);
        Ps[col * kLd + row] =
            p_bf16 ? __bfloat162float(__float2bfloat16_rn(p)) : p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, o));
      corr[r] = expf(__fsub_rn(m[r], m_new));
      l[r] = __fadd_rn(__fmul_rn(l[r], corr[r]), psum);
      m[r] = m_new;
    }
    __syncthreads();  // every thread is done reading K

    // V of this block into the same buffer, row-major
    for (int e = tid; e < bkv * dh; e += kThreads) {
      const int jj = e / dh, d = e % dh;
      KVs[jj * kLd + d] =
          kv0 + jj < Skv ? widen(vg[(long long)(kv0 + jj) * dh + d]) : 0.f;
    }
    __syncthreads();

    // acc = acc * corr + p @ v, the products summed into the rescaled
    // accumulator; per kv row, 8 p and 8 v values feed 64 FMAs
#pragma unroll
    for (int r = 0; r < kT; ++r)
#pragma unroll
      for (int c = 0; c < kT; ++c) acc[r][c] = __fmul_rn(acc[r][c], corr[r]);
    for (int jj = 0; jj < bkv; ++jj) {
      float pr[kT], vc[kT];
#pragma unroll
      for (int r = 0; r < kT; ++r) pr[r] = Ps[jj * kLd + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < kT; ++c) vc[c] = KVs[jj * kLd + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < kT; ++r)
#pragma unroll
        for (int c = 0; c < kT; ++c) acc[r][c] = fmaf(pr[r], vc[c], acc[r][c]);
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
      if (d < dh) oh[(long long)(q0 + row) * dh + d] = __fdiv_rn(acc[r][c], den);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, float* out, int B,
           int H, int KvH, int Sq, int Skv, int dh, int bq, int bkv,
           float scale, int causal, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        fa_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const dim3 grid((Sq + bq - 1) / bq, H, B);
  fa_fwd<T><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out, H, KvH, Sq, Skv, dh, bq, bkv, scale,
      causal, sizeof(T) == 2);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, Sq, dh), k and v (B, KvH, Skv, dh), float32 (bf16 = 0) or
// bfloat16 (bf16 = 1); out (B, H, Sq, dh) float32; all contiguous.
// 1 <= dh <= 128, 1 <= bq, bkv <= 128, H % KvH == 0.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, float* out, int B, int H,
                                   int KvH, int Sq, int Skv, int dh, int bq,
                                   int bkv, float scale, int causal, int bf16,
                                   cudaStream_t stream) {
  if (B < 1 || H < 1 || KvH < 1 || H % KvH || Sq < 1 || Skv < 1 || dh < 1 ||
      dh > kTile || bq < 1 || bq > kTile || bkv < 1 || bkv > kTile)
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, out, B, H, KvH, Sq, Skv, dh, bq,
                                 bkv, scale, causal, stream);
  return launch<float>(q, k, v, out, B, H, KvH, Sq, Skv, dh, bq, bkv, scale,
                       causal, stream);
}

// Depthwise convolution, NHWC x (kh, kw, C) -> NHWC, for Hopper (sm_90a),
// on the CUDA cores: float32 or bfloat16 input and filter (one dtype),
// widened to float32 as they are read (exact), float32 multiplies and
// adds, and a float32 or bfloat16 output rounded once.
//
// Replaces: src/repro/kernels/dwconv.py::dwconv (pallas_call at
// dwconv.py:80), the TPU kernel that keeps a row tile and its halo of a
// padded copy of the input resident in VMEM and does the kh*kw
// multiply-adds per output on the VPU.
//
// Bound on this card: bytes.  There is no reduction over channels: each
// output takes kh*kw multiply-adds (18 FLOP for 3x3) against at least 8
// bytes of input and output, about 2 FLOP/byte, far below the ridge of
// any of the card's rates against HBM.  Tensor cores do not apply.
//
// Design: a CTA computes a tile of th x tw output pixels of one image for
// nvc channel vectors, a vector being the 16 bytes of 4 float32 or 8
// bfloat16 channels (one element where C is not a multiple of that, or a
// pointer is not 16-byte aligned: the scalar path).  It fills its input
// patch, ((th-1)*sh+kh) x ((tw-1)*sw+kw) pixels x nvc vectors, into shared
// memory once with 16-byte cp.async copies (zero-filled where the patch
// hangs over the image edge: that is the padding, and no padded copy of
// the input exists in device memory), and the tile's kh*kw weight vectors
// beside it; each input byte of a tile comes from memory once, the halo
// from a neighbouring tile's reads in L2.  Thread t fills vector t % nvc of
// every (blockDim / nvc)-th patch pixel, stepping its (row, column) by
// additions.  Each thread then computes kStrip = 4 neighbouring outputs
// along W for one vector: for each filter row it reads the (4-1)*sw+kw
// patch vectors the four outputs share once into registers (3x3 filters
// at stride 1 and 2 have their own unrolled instances; other filters read
// each tap from shared memory), so a 3x3 stride-1 output costs 1.5 shared
// loads a row instead of 3.  Each output sums its taps in the reference's
// order (dh-major, then dw) with separately rounded multiply and add
// (__fmul_rn / __fadd_rn: no contraction), as the plain version does, so
// the two agree bit for bit; the patch's zeros are multiplied like any
// other input, as the plain version's padded zeros are.  The host's
// planner (dwconv.dw_plan) picks th, tw and nvc from the geometry and the
// SM count; CTAs run several to an SM, so one CTA's fill overlaps
// another's taps.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"
#include "dtypes.cuh"

namespace {

constexpr int kStrip = 4;          // output pixels along W per thread
constexpr int kMaxThreads = 256;
constexpr int kMaxVectors = 32;    // channel vectors per CTA, a power of two

struct Geo {
  int N, H, W, C, kh, kw, sh, sw, pt, pl, H_out, W_out;
  int th, tw, nvc, nv, n_th, n_tw, n_chunks;
};

// CV channels of one patch or weight slot as float32: 16 bytes of TI
// (vectorised) or one float (the scalar path widens as it fills)
template <typename TI, bool VEC>
struct Slot {
  static constexpr int kCV = VEC ? 16 / (int)sizeof(TI) : 1;
  using T = typename std::conditional<VEC, uint4, float>::type;
};

__device__ __forceinline__ void unpack(const uint4 q, float (&f)[4]) {
  f[0] = __uint_as_float(q.x);
  f[1] = __uint_as_float(q.y);
  f[2] = __uint_as_float(q.z);
  f[3] = __uint_as_float(q.w);
}

__device__ __forceinline__ void unpack(const uint4 q, float (&f)[8]) {
  const unsigned wd[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // little-endian: element 2i is the low half
    f[2 * i] = __uint_as_float(wd[i] << 16);
    f[2 * i + 1] = __uint_as_float(wd[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ void unpack(const float q, float (&f)[1]) {
  f[0] = q;
}

// out[o .. o + CV) = acc, rounded to the output type
template <int CV>
__device__ __forceinline__ void store(void* out, int out_bf16, long long o,
                                      const float (&acc)[CV]) {
  if (out_bf16) {
    bf16* p = static_cast<bf16*>(out) + o;
    if constexpr (CV == 1) {
      p[0] = __float2bfloat16_rn(acc[0]);
    } else {
      unsigned wd[CV / 2];
#pragma unroll
      for (int i = 0; i < CV / 2; ++i) {
        const __nv_bfloat162 h =
            __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
        wd[i] = *reinterpret_cast<const unsigned*>(&h);
      }
      if constexpr (CV == 4)
        *reinterpret_cast<uint2*>(p) = make_uint2(wd[0], wd[1]);
      else
        *reinterpret_cast<uint4*>(p) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
  } else {
    float* p = static_cast<float*>(out) + o;
    if constexpr (CV == 1) {
      p[0] = acc[0];
    } else {
#pragma unroll
      for (int i = 0; i < CV; i += 4)
        *reinterpret_cast<float4*>(p + i) =
            make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
    }
  }
}

template <int CV>
__device__ __forceinline__ void mac(float (&acc)[CV], const float (&x)[CV],
                                    const float (&w)[CV]) {
#pragma unroll
  for (int c = 0; c < CV; ++c) acc[c] = __fadd_rn(acc[c], __fmul_rn(x[c], w[c]));
}

// KW, SW: the filter width and W stride of an unrolled instance; 0 for the
// instance that takes them at run time
template <typename TI, int KW, int SW, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
dw_tile(const TI* __restrict__ x, const TI* __restrict__ w,
        void* __restrict__ out, int out_bf16, const Geo g) {
  constexpr int CV = Slot<TI, VEC>::kCV;
  using S = typename Slot<TI, VEC>::T;
  const int kw = KW ? KW : g.kw, sw = SW ? SW : g.sw;
  const int ph = (g.th - 1) * g.sh + g.kh, pw = (g.tw - 1) * sw + kw;
  const int nvc = g.nvc;
  extern __shared__ uint4 smem[];
  S* patch = reinterpret_cast<S*>(smem);       // (ph, pw, nvc)
  S* wt = patch + ph * pw * nvc;               // (kh, kw, nvc)

  int blk = blockIdx.x;  // ((n * n_th + ty) * n_tw + tx) * n_chunks + chunk
  const int chunk = blk % g.n_chunks;
  blk /= g.n_chunks;
  const int tx = blk % g.n_tw;
  blk /= g.n_tw;
  const int ty = blk % g.n_th, n = blk / g.n_th;
  const int oh0 = ty * g.th, ow0 = tx * g.tw;
  const int ih0 = oh0 * g.sh - g.pt, iw0 = ow0 * sw - g.pl;
  const int v = threadIdx.x % nvc;  // blockDim is a multiple of nvc
  const int cv = chunk * nvc + v;   // this thread's vector of C
  const bool live = cv < g.nv;
  const int per = blockDim.x / nvc;  // pixels a fill pass
  const TI* xn = x + (long long)n * g.H * g.W * g.C + (long long)cv * CV;

  {  // the patch, row-major; (pr, pc) advance by (per / pw, per % pw)
    const int p0 = threadIdx.x / nvc, dr = per / pw, dc = per % pw;
    int pr = p0 / pw, pc = p0 % pw;
    while (pr < ph) {
      const int ih = ih0 + pr, iw = iw0 + pc;
      const bool ok = live && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W;
      S* dst = patch + (pr * pw + pc) * nvc + v;
      const TI* src = xn + ((long long)ih * g.W + iw) * g.C;
      if constexpr (VEC)
        cp_async16(dst, ok ? src : x, ok ? 16 : 0);
      else
        *dst = ok ? widen(*src) : 0.f;
      pr += dr;
      pc += dc;
      if (pc >= pw) {
        pc -= pw;
        ++pr;
      }
    }
  }
  for (int t = threadIdx.x / nvc; t < g.kh * kw; t += per) {
    S* dst = wt + t * nvc + v;
    const TI* src = w + (long long)t * g.C + (long long)cv * CV;
    if constexpr (VEC)
      cp_async16(dst, live ? src : w, live ? 16 : 0);
    else
      *dst = live ? widen(*src) : 0.f;
  }
  if constexpr (VEC) {
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();

  const int strips = g.tw / kStrip;
  const int s = threadIdx.x / nvc;  // this thread's strip of the tile
  const int sy = s / strips, sx = s - sy * strips;
  const int oh = oh0 + sy, ow = ow0 + sx * kStrip;
  if (!live || sy >= g.th || oh >= g.H_out || ow >= g.W_out) return;

  float acc[kStrip][CV];
#pragma unroll
  for (int t = 0; t < kStrip; ++t)
#pragma unroll
    for (int c = 0; c < CV; ++c) acc[t][c] = 0.f;
  const S* prow = patch + (sy * g.sh * pw + sx * kStrip * sw) * nvc + v;
  const S* wrow = wt + v;
  for (int dh = 0; dh < g.kh; ++dh, prow += pw * nvc, wrow += kw * nvc) {
    if constexpr (KW > 0) {
      constexpr int kSpan = (kStrip - 1) * SW + KW;
      float wf[KW][CV], xf[kSpan][CV];
#pragma unroll
      for (int dw = 0; dw < KW; ++dw) unpack(wrow[dw * nvc], wf[dw]);
#pragma unroll
      for (int i = 0; i < kSpan; ++i) unpack(prow[i * nvc], xf[i]);
#pragma unroll
      for (int t = 0; t < kStrip; ++t)
#pragma unroll
        for (int dw = 0; dw < KW; ++dw) mac(acc[t], xf[t * SW + dw], wf[dw]);
    } else {
      for (int dw = 0; dw < kw; ++dw) {
        float wf[CV];
        unpack(wrow[dw * nvc], wf);
#pragma unroll
        for (int t = 0; t < kStrip; ++t) {
          float xf[CV];
          unpack(prow[(t * sw + dw) * nvc], xf);
          mac(acc[t], xf, wf);
        }
      }
    }
  }
  const long long o = (((long long)n * g.H_out + oh) * g.W_out + ow) * g.C +
                      (long long)cv * CV;
#pragma unroll
  for (int t = 0; t < kStrip; ++t)
    if (ow + t < g.W_out) store<CV>(out, out_bf16, o + (long long)t * g.C,
                                    acc[t]);
}

template <typename TI, int KW, int SW, bool VEC>
int launch(const void* x, const void* w, void* out, int out_bf16,
           const Geo& g, cudaStream_t stream) {
  using S = typename Slot<TI, VEC>::T;
  const int ph = (g.th - 1) * g.sh + g.kh, pw = (g.tw - 1) * g.sw + g.kw;
  const size_t smem =
      sizeof(S) * (size_t)g.nvc * ((size_t)ph * pw + (size_t)g.kh * g.kw);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dw_tile<TI, KW, SW, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int units = g.th * (g.tw / kStrip) * g.nvc;
  const int threads = (units + 31) / 32 * 32;
  const long long ctas = (long long)g.N * g.n_th * g.n_tw * g.n_chunks;
  dw_tile<TI, KW, SW, VEC><<<(unsigned)ctas, threads, smem, stream>>>(
      static_cast<const TI*>(x), static_cast<const TI*>(w), out, out_bf16, g);
  return (int)cudaGetLastError();
}

template <typename TI, bool VEC>
int dispatch(const void* x, const void* w, void* out, int out_bf16,
             const Geo& g, cudaStream_t stream) {
  if (g.kw == 3 && g.sw == 1)
    return launch<TI, 3, 1, VEC>(x, w, out, out_bf16, g, stream);
  if (g.kw == 3 && g.sw == 2)
    return launch<TI, 3, 2, VEC>(x, w, out, out_bf16, g, stream);
  return launch<TI, 0, 0, VEC>(x, w, out, out_bf16, g, stream);
}

}  // namespace

// x (N, H, W, C), w (kh, kw, C) float32 (in_bf16 = 0) or bfloat16
// (in_bf16 = 1), out (N, H_out, W_out, C) float32 or (out_bf16 = 1)
// bfloat16, contiguous.  args: N, H, W, C, kh, kw, sh, sw, pt, pl, H_out,
// W_out, th, tw, nvc, vec, in_bf16, out_bf16.  Padding is (pt, pl) at the
// top / left; the bottom and right padding are implied by H_out / W_out.
// The tile is th x tw output pixels (tw a multiple of 4) x nvc channel
// vectors (a power of two up to 32; th * tw / 4 * nvc <= 256); vec = 1
// takes 16-byte vectors (C a multiple of 16 bytes' elements, x, w and out
// 16-byte aligned), vec = 0 one element each.
extern "C" int dwconv(const void* x, const void* w, void* out,
                      const int* args, cudaStream_t stream) {
  Geo g;
  g.N = args[0], g.H = args[1], g.W = args[2], g.C = args[3];
  g.kh = args[4], g.kw = args[5], g.sh = args[6], g.sw = args[7];
  g.pt = args[8], g.pl = args[9], g.H_out = args[10], g.W_out = args[11];
  g.th = args[12], g.tw = args[13], g.nvc = args[14];
  const int vec = args[15], in_bf16 = args[16], out_bf16 = args[17];
  const int cv = vec ? (in_bf16 ? 8 : 4) : 1;
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
      reinterpret_cast<uintptr_t>(out);
  if (g.N < 1 || g.C < 1 || g.H_out < 1 || g.W_out < 1 || g.kh < 1 ||
      g.kw < 1 || g.sh < 1 || g.sw < 1 || g.th < 1 || g.tw < kStrip ||
      g.tw % kStrip != 0 || g.nvc < 1 || g.nvc > kMaxVectors ||
      (g.nvc & (g.nvc - 1)) != 0 ||
      g.th * (g.tw / kStrip) * g.nvc > kMaxThreads ||
      (vec && (g.C % cv != 0 || align % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  g.nv = (g.C + cv - 1) / cv;
  g.n_th = (g.H_out + g.th - 1) / g.th;
  g.n_tw = (g.W_out + g.tw - 1) / g.tw;
  g.n_chunks = (g.nv + g.nvc - 1) / g.nvc;
  if ((long long)g.N * g.n_th * g.n_tw * g.n_chunks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (in_bf16)
    return vec ? dispatch<bf16, true>(x, w, out, out_bf16, g, stream)
               : dispatch<bf16, false>(x, w, out, out_bf16, g, stream);
  return vec ? dispatch<float, true>(x, w, out, out_bf16, g, stream)
             : dispatch<float, false>(x, w, out, out_bf16, g, stream);
}

// the constants the wrapper's planner copies
extern "C" void dwconv_tiles(int* t) {
  t[0] = kStrip;
  t[1] = kMaxThreads;
  t[2] = kMaxVectors;
}

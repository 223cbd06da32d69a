// Depthwise convolution, NHWC x (kh, kw, C) -> NHWC, for Hopper (sm_90a),
// on the CUDA cores: float32 or bfloat16 input and filter (one dtype),
// widened to float32 as they are stored in shared memory (exact), float32
// multiply-adds, and a float32 or bfloat16 output rounded once.
//
// Replaces: src/repro/kernels/dwconv.py::dwconv (pallas_call at
// dwconv.py:80), the TPU kernel that keeps a row tile and its halo of a
// padded copy of the input resident in VMEM and does the kh*kw
// multiply-adds per output on the VPU.
//
// Bound on this card: bytes.  There is no reduction over channels: each
// output takes kh*kw multiply-adds (18 FLOP for 3x3) against at least 8
// bytes of input and output, about 2 FLOP/byte, far below the ~20
// FLOP/byte ridge of float32 FMA against HBM.  Tensor cores do not apply.
//
// Design: one CTA of 256 threads computes a tile of th x tw output pixels
// of one image for 32 channels (one warp's lanes).  It loads the input
// patch its pixels need, ((th-1)*sh+kh) x ((tw-1)*sw+kw) x 32, into shared
// memory once, writing zeros where the patch hangs over the image edge
// (that is the padding: no padded copy of the input exists in device
// memory), and the tile's kh*kw x 32 weights beside it.  Lane l of every
// warp owns channel c0+l, so each warp's loads and stores touch 32
// neighbouring floats of NHWC's C axis (128 bytes) and its shared-memory
// reads hit 32 distinct banks; the 8 warps split the pixels.  Each output
// sums its taps in the reference's order (dh-major, then dw) with
// separately rounded multiply and add, as the plain version does, so the
// two agree bit for bit.  Channels past C (C % 32 != 0) are masked;
// pixels past the map (7x7 maps under an 8x8 tile) are skipped.

#include <cuda_runtime.h>

#include "dtypes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCB = 32;                   // channels per CTA: one per lane
constexpr int kGroups = kThreads / kCB;   // warps, each a pixel group

template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
dw_tile(const TI* __restrict__ x, const TI* __restrict__ w,
        TO* __restrict__ out, int H, int W, int C, int kh, int kw, int sh,
        int sw, int pt, int pl, int H_out, int W_out, int th, int tw,
        int n_tw) {
  extern __shared__ float smem[];
  const int PH = (th - 1) * sh + kh, PW = (tw - 1) * sw + kw;
  float* patch = smem;                   // (PH, PW, kCB)
  float* wt = smem + PH * PW * kCB;      // (kh, kw, kCB)
  const int lane = threadIdx.x % kCB, grp = threadIdx.x / kCB;
  const int n = blockIdx.z;
  const int c = blockIdx.y * kCB + lane;
  const bool live = c < C;
  const int oh0 = (blockIdx.x / n_tw) * th, ow0 = (blockIdx.x % n_tw) * tw;
  const int ih0 = oh0 * sh - pt, iw0 = ow0 * sw - pl;

  const TI* xn = x + (long long)n * H * W * C;
  for (int pix = grp; pix < PH * PW; pix += kGroups) {
    const int ih = ih0 + pix / PW, iw = iw0 + pix % PW;
    float v = 0.f;
    if (live && ih >= 0 && ih < H && iw >= 0 && iw < W)
      v = widen(xn[((long long)ih * W + iw) * C + c]);
    patch[pix * kCB + lane] = v;
  }
  for (int t = grp; t < kh * kw; t += kGroups)
    wt[t * kCB + lane] = live ? widen(w[(long long)t * C + c]) : 0.f;
  __syncthreads();
  if (!live) return;  // no barrier follows

  for (int p = grp; p < th * tw; p += kGroups) {
    const int oh = oh0 + p / tw, ow = ow0 + p % tw;
    if (oh >= H_out || ow >= W_out) continue;
    const float* pp = patch + ((p / tw) * sh * PW + (p % tw) * sw) * kCB + lane;
    float acc = 0.f;
    for (int dh = 0; dh < kh; ++dh)
      for (int dw = 0; dw < kw; ++dw)
        acc = __fadd_rn(acc, __fmul_rn(pp[(dh * PW + dw) * kCB],
                                       wt[(dh * kw + dw) * kCB + lane]));
    out[(((long long)n * H_out + oh) * W_out + ow) * C + c] =
        narrow<TO>(acc);
  }
}

template <typename TI, typename TO>
int run(const void* x, const void* w, void* out, int N, int H, int W, int C,
        int kh, int kw, int sh, int sw, int pt, int pl, int H_out, int W_out,
        int th, int tw, cudaStream_t stream) {
  const int PH = (th - 1) * sh + kh, PW = (tw - 1) * sw + kw;
  const size_t smem =
      sizeof(float) * ((size_t)PH * PW * kCB + (size_t)kh * kw * kCB);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dw_tile<TI, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_th = (H_out + th - 1) / th, n_tw = (W_out + tw - 1) / tw;
  const dim3 grid(n_th * n_tw, (C + kCB - 1) / kCB, N);
  dw_tile<TI, TO><<<grid, kThreads, smem, stream>>>(
      static_cast<const TI*>(x), static_cast<const TI*>(w),
      static_cast<TO*>(out), H, W, C, kh, kw, sh, sw, pt, pl, H_out, W_out,
      th, tw, n_tw);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, H, W, C), w (kh, kw, C) float32 (in_bf16 = 0) or bfloat16
// (in_bf16 = 1), out (N, H_out, W_out, C) float32 or (out_bf16 = 1)
// bfloat16, contiguous.  Padding is (pt, pl) at the top / left; the bottom
// and right padding are implied by H_out / W_out.  The tile is th x tw
// output pixels.
extern "C" int dwconv(const void* x, const void* w, void* out, int N, int H,
                      int W, int C, int kh, int kw, int sh, int sw, int pt,
                      int pl, int H_out, int W_out, int th, int tw,
                      int in_bf16, int out_bf16, cudaStream_t stream) {
  if (th < 1 || tw < 1 || N < 1 || N > 65535 || C < 1 || H_out < 1 ||
      W_out < 1 || kh < 1 || kw < 1 || sh < 1 || sw < 1)
    return (int)cudaErrorInvalidValue;
  return IO_DISPATCH(in_bf16, out_bf16, run, x, w, out, N, H, W, C, kh, kw,
                     sh, sw, pt, pl, H_out, W_out, th, tw, stream);
}

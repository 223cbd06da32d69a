// Implicit-im2col convolution, NHWC x HWIO -> NHWC, for Hopper (sm_90a),
// on the CUDA cores: float32 or bfloat16 input and filter (one dtype),
// widened to float32 as they are stored in shared memory (exact), float32
// sums, and a float32 or bfloat16 output rounded once at the end.
//
// Replaces: src/repro/kernels/im2col_conv.py::im2col_conv (pallas_call at
// im2col_conv.py:117), the TPU kernel that keeps a row tile and its halo
// resident in VMEM and feeds kh*kw shifted strided views of it to the MXU
// as GeMMs -- the paper's on-chip im2col.
//
// Bound on this card: operations for every 3x3 and 7x7 conv of ResNet50
// and for the wide 1x1 convs (each input value meets C_out weights and
// each weight 64 pixels); the narrow 1x1 convs (C_in or C_out = 64) sit
// near the ~20 FLOP/byte ridge of float32 FMA against HBM.  fp32 FMA only:
// no TF32, no tensor cores.
//
// Design: the im2col matrix is never built, and neither is a padded copy
// of the input.  One CTA of 256 threads computes a tile of th x tw = 64
// output pixels of one image for BCO (32 or 64) output channels.  For each
// chunk of ck input channels it loads the input patch its pixels need,
// ((th-1)*sh+kh) x ((tw-1)*sw+kw) x ck, into shared memory once, writing
// zeros where the patch hangs over the image edge (that is the padding).
// It then walks the kh*kw taps: per tap it loads that tap's (ck, BCO)
// weight slice and every thread reads its 4 pixels' shifted, strided
// values straight out of the resident patch -- so each input value comes
// from device memory once per (tile, chunk, C_out block) and is reused up
// to kh*kw times on chip.  Each thread keeps 4 pixels x BCO/16 channels of
// f32 sums in registers; channel columns are strided by 16 so a warp's
// weight reads hit 16 neighbouring banks and its stores coalesce.  The
// TPU's whole-width 8-row tile with a 512-deep channel block would need
// ~0.5 MB here; the width is tiled too (with a halo both ways) and the
// channel chunk is at most 32, which keeps a CTA within 48 KB for every
// ResNet50 geometry.

#include <cuda_runtime.h>

#include "dtypes.cuh"

namespace {

constexpr int kThreads = 256;  // 16 pixel groups x 16 channel groups
constexpr int kPix = 64;       // output pixels per CTA (th * tw)

// TC: output channels per thread, BCO = 16 * TC
template <int TC, typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
conv_tile(const TI* __restrict__ x, const TI* __restrict__ w,
          TO* __restrict__ out, int H, int W, int C_in, int kh, int kw,
          int C_out, int sh, int sw, int pt, int pl, int H_out, int W_out,
          int th, int tw, int ck, int n_tw) {
  constexpr int BCO = 16 * TC;
  extern __shared__ float smem[];
  const int PH = (th - 1) * sh + kh, PW = (tw - 1) * sw + kw;
  float* patch = smem;                   // (PH, PW, ck)
  float* wtap = smem + PH * PW * ck;     // (ck, BCO)
  const int tid = threadIdx.x, tc = tid % 16, tp = tid / 16;
  const int n = blockIdx.z;
  const int co0 = blockIdx.y * BCO;
  const int oh0 = (blockIdx.x / n_tw) * th, ow0 = (blockIdx.x % n_tw) * tw;
  const int ih0 = oh0 * sh - pt, iw0 = ow0 * sw - pl;

  int pbase[4];  // patch offset of each of this thread's pixels at tap 0
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = tp + 16 * i;
    pbase[i] = ((p / tw) * sh * PW + (p % tw) * sw) * ck;
  }
  float acc[4][TC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;

  const TI* xn = x + (long long)n * H * W * C_in;
  const int patch_len = PH * PW * ck;
  for (int c0 = 0; c0 < C_in; c0 += ck) {
    const int cc = min(ck, C_in - c0);
    __syncthreads();  // the previous chunk's taps are done with the patch
    for (int e = tid; e < patch_len; e += kThreads) {
      const int c = e % ck, pix = e / ck;
      const int ih = ih0 + pix / PW, iw = iw0 + pix % PW;
      float v = 0.f;
      if (c < cc && ih >= 0 && ih < H && iw >= 0 && iw < W)
        v = widen(xn[((long long)ih * W + iw) * C_in + c0 + c]);
      patch[e] = v;
    }
    for (int dh = 0; dh < kh; ++dh) {
      for (int dw = 0; dw < kw; ++dw) {
        __syncthreads();  // patch stored; the previous tap's weights used
        const TI* wp =
            w + ((long long)(dh * kw + dw) * C_in + c0) * C_out + co0;
        for (int e = tid; e < ck * BCO; e += kThreads) {
          const int c = e / BCO, co = e % BCO;
          wtap[e] = (c < cc && co0 + co < C_out)
                        ? widen(wp[(long long)c * C_out + co]) : 0.f;
        }
        __syncthreads();
        const int toff = (dh * PW + dw) * ck;
        for (int c = 0; c < cc; ++c) {
          float xv[4], wv[TC];
#pragma unroll
          for (int i = 0; i < 4; ++i) xv[i] = patch[pbase[i] + toff + c];
#pragma unroll
          for (int j = 0; j < TC; ++j) wv[j] = wtap[c * BCO + tc + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < TC; ++j)
              acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = tp + 16 * i;
    const int oh = oh0 + p / tw, ow = ow0 + p % tw;
    if (oh >= H_out || ow >= W_out) continue;
    TO* op = out + (((long long)n * H_out + oh) * W_out + ow) * C_out;
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int co = co0 + tc + 16 * j;
      if (co < C_out) op[co] = narrow<TO>(acc[i][j]);
    }
  }
}

template <int TC, typename TI, typename TO>
int launch(const TI* x, const TI* w, TO* out, int N, int H, int W,
           int C_in, int kh, int kw, int C_out, int sh, int sw, int pt,
           int pl, int H_out, int W_out, int th, int tw, int ck,
           cudaStream_t stream) {
  constexpr int BCO = 16 * TC;
  const int PH = (th - 1) * sh + kh, PW = (tw - 1) * sw + kw;
  const size_t smem = sizeof(float) * ((size_t)PH * PW * ck + (size_t)ck * BCO);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_tile<TC, TI, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_th = (H_out + th - 1) / th, n_tw = (W_out + tw - 1) / tw;
  const dim3 grid(n_th * n_tw, (C_out + BCO - 1) / BCO, N);
  conv_tile<TC, TI, TO><<<grid, kThreads, smem, stream>>>(
      x, w, out, H, W, C_in, kh, kw, C_out, sh, sw, pt, pl, H_out, W_out,
      th, tw, ck, n_tw);
  return (int)cudaGetLastError();
}

template <typename TI, typename TO>
int run(const void* x_, const void* w_, void* out_, int N, int H, int W,
        int C_in, int kh, int kw, int C_out, int sh, int sw, int pt, int pl,
        int H_out, int W_out, int th, int tw, int ck, int bco,
        cudaStream_t stream) {
  const TI* x = static_cast<const TI*>(x_);
  const TI* w = static_cast<const TI*>(w_);
  TO* out = static_cast<TO*>(out_);
  if (bco == 64)
    return launch<4>(x, w, out, N, H, W, C_in, kh, kw, C_out, sh, sw, pt, pl,
                     H_out, W_out, th, tw, ck, stream);
  return launch<2>(x, w, out, N, H, W, C_in, kh, kw, C_out, sh, sw, pt, pl,
                   H_out, W_out, th, tw, ck, stream);
}

}  // namespace

// x (N, H, W, C_in), w (kh, kw, C_in, C_out) float32 (in_bf16 = 0) or
// bfloat16 (in_bf16 = 1), out (N, H_out, W_out, C_out) float32 or
// (out_bf16 = 1) bfloat16, contiguous.  Padding is (pt, pl) at the top /
// left; the bottom and right padding are implied by H_out / W_out.
// th * tw must be 64 and bco 32 or 64.
extern "C" int im2col_conv(const void* x, const void* w, void* out, int N,
                           int H, int W, int C_in, int kh, int kw, int C_out,
                           int sh, int sw, int pt, int pl, int H_out,
                           int W_out, int th, int tw, int ck, int bco,
                           int in_bf16, int out_bf16, cudaStream_t stream) {
  if (th * tw != kPix || ck < 1 || N < 1 || N > 65535 ||
      (bco != 32 && bco != 64))
    return (int)cudaErrorInvalidValue;
  return IO_DISPATCH(in_bf16, out_bf16, run, x, w, out, N, H, W, C_in, kh,
                     kw, C_out, sh, sw, pt, pl, H_out, W_out, th, tw, ck, bco,
                     stream);
}

// Implicit-im2col int8 convolution, NHWC x HWIO -> NHWC float32, for Hopper
// (sm_90a), on the CUDA cores with __dp4a (four int8 products summed into
// an int32 per instruction).
//
// Replaces: src/repro/kernels/quant_gemm.py::quant_im2col_conv (pallas_call
// at quant_gemm.py:471), the TPU kernel that keeps an int8 row tile and its
// halo resident in VMEM, feeds kh*kw shifted strided views of it to the MXU
// with int32 accumulation, and casts once: acc.astype(f32) * scale[c_out].
//
// Bound on this card: operations for the 3x3 and 7x7 convs of ResNet50 and
// the wide 1x1 convs (against the 1,979 TOP/s dense int8 tensor-core rate);
// the narrow 1x1 convs sit near the ridge.  This first kernel does not use
// the tensor cores: __dp4a runs on the CUDA cores at a quarter of the
// float32 FMA instruction rate per 4 products, so it is far from either
// bound -- the tensor-core (mma/wgmma s8) version is later work.
//
// Design: the structure of im2col_conv.cu with one-byte operands.  One CTA
// of 256 threads computes th x tw = 64 output pixels of one image for BCO
// (32 or 64) output channels.  For each chunk of ck input channels (ck a
// multiple of 4, at most 128: four times the float kernel's chunk in about
// the same shared memory) it loads the input patch its pixels need into
// shared memory once, as int32 words that pack 4 neighbouring channels,
// writing zeros where the patch hangs over the image edge: with symmetric
// quantization the zero point is 0, so that zero is the padding, exactly.
// Channels past C_in in the last word are zero too (the stem has C_in = 3).
// It then walks the kh*kw taps: per tap it packs that tap's (ck, BCO)
// weight slice the same way, 4 input channels of one output channel per
// word, and every thread reads its 4 pixels' shifted, strided words out of
// the resident patch and does one __dp4a per word and output channel.
// Each thread keeps 4 pixels x BCO/16 channels of int32 sums; channel
// columns are strided by 16 so a warp's weight reads hit 16 neighbouring
// banks.  The epilogue is the reference's: float(acc) first, then one
// multiply by the combined scale, stored as float32.  No padded copy of
// the input and no im2col matrix exist in device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 pixel groups x 16 channel groups
constexpr int kPix = 64;       // output pixels per CTA (th * tw)

// four bytes of src (those below nb) packed little-endian into one word
__device__ __forceinline__ int pack_bytes(const int8_t* src, long long step,
                                          int nb) {
  unsigned u = 0;
  for (int b = 0; b < nb && b < 4; ++b)
    u |= (unsigned)(uint8_t)src[b * step] << (8 * b);
  return (int)u;
}

template <int TC>  // output channels per thread; BCO = 16 * TC
__global__ void __launch_bounds__(kThreads)
qconv_tile(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ scale, float* __restrict__ out, int H,
           int W, int C_in, int kh, int kw, int C_out, int sh, int sw, int pt,
           int pl, int H_out, int W_out, int th, int tw, int ck, int n_tw,
           int vec) {
  constexpr int BCO = 16 * TC;
  extern __shared__ int smem[];
  const int PH = (th - 1) * sh + kh, PW = (tw - 1) * sw + kw;
  const int cw = ck / 4;                 // words per pixel of a chunk
  int* patch = smem;                     // (PH, PW, cw)
  int* wtap = smem + PH * PW * cw;       // (cw, BCO)
  const int tid = threadIdx.x, tc = tid % 16, tp = tid / 16;
  const int n = blockIdx.z;
  const int co0 = blockIdx.y * BCO;
  const int oh0 = (blockIdx.x / n_tw) * th, ow0 = (blockIdx.x % n_tw) * tw;
  const int ih0 = oh0 * sh - pt, iw0 = ow0 * sw - pl;

  int pbase[4];  // patch word offset of each of this thread's pixels, tap 0
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = tp + 16 * i;
    pbase[i] = ((p / tw) * sh * PW + (p % tw) * sw) * cw;
  }
  int acc[4][TC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0;

  const int8_t* xn = x + (long long)n * H * W * C_in;
  const int patch_words = PH * PW * cw;
  for (int c0 = 0; c0 < C_in; c0 += ck) {
    const int cc = min(ck, C_in - c0);
    const int cwc = (cc + 3) / 4;        // words that hold real channels
    __syncthreads();  // the previous chunk's taps are done with the patch
    for (int e = tid; e < patch_words; e += kThreads) {
      const int q = e % cw, pix = e / cw;
      const int ih = ih0 + pix / PW, iw = iw0 + pix % PW;
      int v = 0;
      if (q < cwc && ih >= 0 && ih < H && iw >= 0 && iw < W) {
        const int8_t* src =
            xn + ((long long)ih * W + iw) * C_in + c0 + 4 * q;
        v = vec ? *reinterpret_cast<const int*>(src)
                : pack_bytes(src, 1, cc - 4 * q);
      }
      patch[e] = v;
    }
    for (int dh = 0; dh < kh; ++dh) {
      for (int dw = 0; dw < kw; ++dw) {
        __syncthreads();  // patch stored; the previous tap's weights used
        const int8_t* wp =
            w + ((long long)(dh * kw + dw) * C_in + c0) * C_out + co0;
        for (int e = tid; e < cw * BCO; e += kThreads) {
          const int q = e / BCO, co = e % BCO;
          wtap[e] = (co0 + co < C_out)
                        ? pack_bytes(wp + (long long)4 * q * C_out + co,
                                     C_out, cc - 4 * q)
                        : 0;
        }
        __syncthreads();
        const int toff = (dh * PW + dw) * cw;
        for (int q = 0; q < cwc; ++q) {
          int xv[4], wv[TC];
#pragma unroll
          for (int i = 0; i < 4; ++i) xv[i] = patch[pbase[i] + toff + q];
#pragma unroll
          for (int j = 0; j < TC; ++j) wv[j] = wtap[q * BCO + tc + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < TC; ++j)
              acc[i][j] = __dp4a(xv[i], wv[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = tp + 16 * i;
    const int oh = oh0 + p / tw, ow = ow0 + p % tw;
    if (oh >= H_out || ow >= W_out) continue;
    float* op = out + (((long long)n * H_out + oh) * W_out + ow) * C_out;
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int co = co0 + tc + 16 * j;
      if (co < C_out) op[co] = __fmul_rn(__int2float_rn(acc[i][j]), scale[co]);
    }
  }
}

template <int TC>
int launch(const int8_t* x, const int8_t* w, const float* scale, float* out,
           int N, int H, int W, int C_in, int kh, int kw, int C_out, int sh,
           int sw, int pt, int pl, int H_out, int W_out, int th, int tw,
           int ck, int vec, cudaStream_t stream) {
  constexpr int BCO = 16 * TC;
  const int PH = (th - 1) * sh + kh, PW = (tw - 1) * sw + kw;
  const size_t smem = sizeof(int) * ((size_t)PH * PW * (ck / 4) +
                                     (size_t)(ck / 4) * BCO);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        qconv_tile<TC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_th = (H_out + th - 1) / th, n_tw = (W_out + tw - 1) / tw;
  const dim3 grid(n_th * n_tw, (C_out + BCO - 1) / BCO, N);
  qconv_tile<TC><<<grid, kThreads, smem, stream>>>(
      x, w, scale, out, H, W, C_in, kh, kw, C_out, sh, sw, pt, pl, H_out,
      W_out, th, tw, ck, n_tw, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, H, W, C_in) int8, w (kh, kw, C_in, C_out) int8, scale (C_out,)
// float32, out (N, H_out, W_out, C_out) float32, all contiguous.  Padding
// is (pt, pl) at the top / left; the bottom and right padding are implied
// by H_out / W_out.  th * tw must be 64, ck a positive multiple of 4 and
// bco 32 or 64.  vec = 1 loads the input 4 channels at a time, which needs
// C_in % 4 == 0 and x aligned to 4 bytes.
extern "C" int quant_im2col_conv_s8(const int8_t* x, const int8_t* w,
                                    const float* scale, float* out, int N,
                                    int H, int W, int C_in, int kh, int kw,
                                    int C_out, int sh, int sw, int pt, int pl,
                                    int H_out, int W_out, int th, int tw,
                                    int ck, int bco, int vec,
                                    cudaStream_t stream) {
  if (th * tw != kPix || ck < 4 || ck % 4 || N < 1 || N > 65535 ||
      (bco != 32 && bco != 64) || (vec && C_in % 4))
    return (int)cudaErrorInvalidValue;
  if (bco == 64)
    return launch<4>(x, w, scale, out, N, H, W, C_in, kh, kw, C_out, sh, sw,
                     pt, pl, H_out, W_out, th, tw, ck, vec, stream);
  return launch<2>(x, w, scale, out, N, H, W, C_in, kh, kw, C_out, sh, sw, pt,
                   pl, H_out, W_out, th, tw, ck, vec, stream);
}

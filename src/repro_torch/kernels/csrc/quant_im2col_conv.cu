// Implicit-im2col int8 convolution, NHWC x HWIO -> NHWC, for Hopper
// (sm_90a), on the s8 tensor cores: int8 input and filter, int32 sums
// (exact), and the reference's epilogue float(acc) * scale[c_out] written
// as float32 or rounded once to bfloat16.
//
// Replaces: src/repro/kernels/quant_gemm.py::quant_im2col_conv (pallas_call
// at quant_gemm.py:471), the TPU kernel that keeps an int8 row tile and its
// halo resident in VMEM, feeds kh*kw shifted strided views of it to the MXU
// with int32 accumulation, and casts once: acc.astype(f32) * scale[c_out];
// and this file's first design (qconv_tile: 64 pixels x 32 or 64 channels
// on __dp4a, each tap's weight slice repacked a byte at a time).
//
// Bound on this card: bytes for most of ResNet50's and MobileNetV1's convs
// at batch 8 (input and filter once, a float32 output), operations at the
// dense int8 tensor rate for the widest 3x3 convs.
//
// Design: the structure of im2col_conv.cu with one-byte operands and one
// product per MAC.  A GeMM row is an output pixel, a column an output
// channel, and K walks (channel chunk, tap).
//   * A CTA of 256 threads computes up to 128 pixels -- a box of ni images
//     x th rows x tw columns, several whole images where the map is small
//     -- for BN (32, 64 or 128) output channels, eight warps of 64 x BN/4
//     (32 x 16 at BN = 32); empty m16 tiles are skipped.
//   * For each chunk of ck (64 or 32) input channels the input patch that
//     the box's pixels need lands in shared memory once, by cp.async, with
//     zeros where it hangs over the border: with symmetric quantization the
//     zero point is 0, so zero is the padding exactly.  Every tap reads its
//     A fragments from that patch with ldmatrix, one row address per lane
//     -- the tap's shifted, strided pixel, a uniform offset from the
//     pixel's base -- so each input byte comes from device memory once per
//     (box, chunk, channel tile) and feeds up to kh*kw products on chip:
//     the paper's on-chip im2col on the tensor cores.  A position's ck
//     bytes are followed by 16 pad bytes, and a patch row stores its
//     columns by phase (column C at (C % pw) * ceil(PW / pw) + C / pw, pw =
//     min(sw, kw)), so the eight rows of an ldmatrix phase sit at
//     consecutive positions at stride 1 and stride 2 alike and hit eight
//     bank groups.  Patch buffers: enough for the chunks whose patches the
//     ring loads ahead while the current chunk's taps still read theirs.
//   * The (ck, BN) weight slice of each tap streams through a ring of 4
//     cp.async stages and is turned K-major for the s8 B fragment by
//     mma.cuh's 4 x 4 __byte_perm transpose (as quant_gemm.cu's);
//     products on mma.sync.m16n8k32 s8 x s8 -> s32.
//   * The channel chunks are split across CTAs where the (box x channel
//     tile) grid would leave the card under-filled (ResNet50's stages 4-5
//     at batch 8): int32 partial planes (ksplit, pixels, C_out), summed
//     exactly by split_k.cuh, then one cast and one multiply by the scale.
//   * A stem of at most 4 channels folds its taps along the width into K:
//     one k32 step per filter row, K = kw x 4 channels (28 -> 32 for the
//     7x7 stem), the A fragments read as words from a patch of 4 channels
//     a position.
//   The wrapper's planner (im2col_conv.py: conv_plan, elem_bytes=1) picks
//   the box, ck, BN and the split, within the 227 KB of shared memory.
//   Ragged channel counts or unaligned tensors take byte loads
//   (synchronous) in the same pipeline.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "cp_async.cuh"
#include "dtypes.cuh"
#include "mma.cuh"
#include "split_k.cuh"

constexpr int kConvRows = 128;    // output pixels (GeMM rows) per CTA
constexpr int kConvStages = 4;    // weight slices in flight
constexpr int kPlanePad = 16;     // bytes after a position's channels
constexpr int kFoldSlack = 64;    // bytes after a folded patch (over-reads)
constexpr int kTilePad = 16;      // bytes after a K-major weight row

namespace {

struct quant_im2col_conv_tag;  // names this library's kernels in a profile

struct QConvArgs {
  int N, H, W, C_in, kh, kw, C_out, sh, sw, pt, pl, Ho, Wo;
  int ni, th, tw;       // the pixel box
  int ck, cpc, nb;      // channels per chunk, chunks per CTA, patch buffers
  int vec, out_bf16;
};

template <int BN>
struct Qv {
  static constexpr int WM = BN >= 64 ? 2 : 4, WN = 8 / WM;   // warps
  static constexpr int WTM = kConvRows / WM;      // 64 or 32 rows a warp
  static constexpr int WTN = BN / WN;             // 16 or 32 columns
  static constexpr int MT = WTM / 16, NT = WTN / 8;
};

// a folded conv (ck == 4: C_in <= 4) walks one step per filter row, its
// K the row's kw taps x 4 channels, in whole k32 steps
__host__ __device__ inline int fold_rows(int kw) {
  return (kw * 4 + 31) / 32 * 32;
}

// the patch geometry of a conv's box.  Unfolded, a row's PW columns are
// stored by phase: column C at slot (C % pw) * PWq + C / pw, PWs slots a row
struct QPatch {
  int ph, pw, PH, PW, PWq, PWs, pos, pitch, bytes;
  __host__ __device__ QPatch(const QConvArgs& g, bool fold) {
    ph = g.sh < g.kh ? g.sh : g.kh;
    pw = g.sw < g.kw ? g.sw : g.kw;
    PH = (g.th - 1) * ph + g.kh;
    PW = (g.tw - 1) * pw + g.kw;
    PWq = fold ? PW : (PW + pw - 1) / pw;
    PWs = fold ? PW : PWq * pw;
    pos = g.ni * PH * PWs;
    pitch = fold ? 4 : g.ck + kPlanePad;
    // one buffer, 16-byte aligned
    bytes = (pos * pitch + (fold ? kFoldSlack : 0) + 15) / 16 * 16;
  }
  // the patch column of a stored slot
  __device__ int col(int slot, bool fold) const {
    return fold ? slot : (slot % PWq) * pw + slot / PWq;
  }
};

// bytes of the three regions of shared memory: patch buffers, weight
// ring, K-major tile (the planner's conv_smem computes the same)
inline long long qconv_smem(const QConvArgs& g, int bn) {
  const bool fold = g.ck == 4;
  const QPatch P(g, fold);
  const int krows = fold ? fold_rows(g.kw) : g.ck;
  return (long long)g.nb * P.bytes + (long long)kConvStages * krows * bn +
         (long long)bn * (krows + kTilePad);
}

// the patch of chunk c0 .. c0 + ck into one buffer
template <bool FOLD>
__device__ __forceinline__ void load_patch(uint8_t* dst,
                                           const int8_t* __restrict__ x,
                                           const QConvArgs& g,
                                           const QPatch& P, int n0, int ih0,
                                           int iw0, int c0) {
  const int per = FOLD ? 4 : (g.vec ? 16 : 4);   // bytes a piece
  const int pieces = FOLD ? 1 : g.ck / per, area = P.PH * P.PWs;
  for (int e = threadIdx.x; e < P.pos * pieces; e += kTcThreads) {
    const int p = e / pieces, q = e % pieces;
    const int img = p / area, rem = p % area;
    const int R = rem / P.PWs, C = P.col(rem % P.PWs, FOLD);
    const int n = n0 + img;
    const int ih = ih0 + (R / P.ph) * g.sh + R % P.ph;
    const int iw = iw0 + (C / P.pw) * g.sw + C % P.pw;
    const int ch = c0 + per * q;
    const bool in = C < P.PW && n < g.N && ih >= 0 && ih < g.H && iw >= 0 &&
                    iw < g.W;
    const int8_t* src =
        x + (((long long)n * g.H + ih) * g.W + iw) * g.C_in + ch;
    uint8_t* d = dst + p * P.pitch + per * q;
    if (!FOLD && g.vec) {
      const bool ok = in && ch < g.C_in;
      cp_async16(d, ok ? src : x, ok ? 16 : 0);
    } else {
      unsigned u = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (in && ch + k < g.C_in) u |= (unsigned)(uint8_t)src[k] << (8 * k);
      *reinterpret_cast<unsigned*>(d) = u;
    }
  }
}

// tap's weight rows c0 .. c0 + KR, columns co0 .. co0 + BN, into a stage
// (KR rows of BN bytes, chunks by s8_chunk); folded: filter row `tap`,
// weight row r is tap dw = r / 4, channel r % 4 (zero past kw and C_in)
template <int BN, int KR, bool FOLD>
__device__ __forceinline__ void load_taps(uint8_t* dst,
                                          const int8_t* __restrict__ w,
                                          const QConvArgs& g, int tap,
                                          int c0, int co0) {
  constexpr int kP = BN / 16;   // 16-byte pieces a row
  for (int e = threadIdx.x; e < KR * kP; e += kTcThreads) {
    const int r = e / kP, q = e % kP, co = co0 + 16 * q;
    int t = tap, ci = c0 + r;
    bool in = ci < g.C_in;
    if (FOLD) {
      t = tap * g.kw + r / 4;
      ci = r % 4;
      in = r / 4 < g.kw && ci < g.C_in;
    }
    const int8_t* src = w + ((long long)t * g.C_in + ci) * g.C_out + co;
    uint8_t* d = dst + r * BN + 16 * s8_chunk<BN>(r, q);
    if (!FOLD && g.vec) {
      const bool ok = in && co < g.C_out;
      cp_async16(d, ok ? src : w, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k)
        d[k] = (in && co + k < g.C_out) ? (uint8_t)src[k] : 0;
    }
  }
}

// grid (boxes, C_out tiles, ksplit); CTA z takes chunks [z * cpc, (z + 1)
// * cpc) of ceil(C_in / ck).  One split: the output, float32 or (out_bf16)
// bfloat16, scaled; else the int32 planes (ksplit, N * Ho * Wo, C_out).
template <int BN, int KR, bool FOLD>
__global__ void __launch_bounds__(kTcThreads)
qconv_tc(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
         const float* __restrict__ scale, int* __restrict__ partial,
         void* __restrict__ out, const QConvArgs g) {
  using C = Qv<BN>;
  constexpr int kLdt = KR + kTilePad;
  extern __shared__ __align__(16) uint8_t smem[];
  const QPatch P(g, FOLD);
  // a step: one tap (kh * kw a chunk), or a folded filter row (kh)
  const int T = FOLD ? g.kh : g.kh * g.kw;
  uint8_t* patch = smem;
  uint8_t* ring = smem + g.nb * P.bytes;
  uint8_t* tile = ring + kConvStages * KR * BN;
  if constexpr (FOLD) {   // the slack a folded fragment may read: zeros
    constexpr int kWords = kFoldSlack / 4;
    for (int e = threadIdx.x; e < g.nb * kWords; e += kTcThreads)
      reinterpret_cast<unsigned*>(patch + e / kWords * P.bytes +
                                  P.pos * 4)[e % kWords] = 0;
  }

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int n_tw = (g.Wo + g.tw - 1) / g.tw, n_th = (g.Ho + g.th - 1) / g.th;
  const int box = blockIdx.x;
  const int n0 = box / (n_tw * n_th) * g.ni;
  const int oh0 = box / n_tw % n_th * g.th, ow0 = box % n_tw * g.tw;
  const int ih0 = oh0 * g.sh - g.pt, iw0 = ow0 * g.sw - g.pl;
  const int co0 = blockIdx.y * BN;
  const int nch = (g.C_in + g.ck - 1) / g.ck;
  const int cbeg = blockIdx.z * g.cpc;
  const int nt = min(g.cpc, nch - cbeg) * T;
  const int box_px = g.th * g.tw, npx = g.ni * box_px;

  // the patch position of a pixel of the box at tap 0 (0 past the box)
  auto pixel_base = [&](int p) {
    const int img = p / box_px, r = p / g.tw % g.th, c = p % g.tw;
    return p < npx ? (img * P.PH + r * P.ph) * P.PWs + c * (FOLD ? P.pw : 1)
                   : 0;
  };
  // each lane's rows: ldmatrix's (lane % 16), or a folded fragment's two
  // (lane / 4 and 8 more)
  int base[C::MT], base8[C::MT];
#pragma unroll
  for (int i = 0; i < C::MT; ++i) {
    const int p0 = wm * C::WTM + 16 * i;
    base[i] = pixel_base(p0 + (FOLD ? lane / 4 : lane % 16));
    base8[i] = FOLD ? pixel_base(p0 + lane / 4 + 8) : 0;
  }

  int acc[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  auto load = [&](int s, int t) {
    const int c = t / T, tap = t % T, c0 = (cbeg + c) * g.ck;
    if (tap == 0)
      load_patch<FOLD>(patch + (c % g.nb) * P.bytes, x, g, P, n0, ih0, iw0,
                       c0);
    load_taps<BN, KR, FOLD>(ring + s * KR * BN, w, g, tap, c0, co0);
  };
  int step = 0;   // the step compute() consumes
  auto compute = [&](int s) {
    const int c = step / T, tap = step % T;
    ++step;
    transpose_s8<KR, BN, kLdt>(ring + s * KR * BN, tile);
    __syncthreads();   // the K-major tile is whole
    const uint8_t* buf = patch + (c % g.nb) * P.bytes;
    const int toff =
        FOLD ? tap * P.PWs
             : (tap / g.kw) * P.PWs + (tap % g.kw % P.pw) * P.PWq +
                   tap % g.kw / P.pw;
#pragma unroll
    for (int kk = 0; kk < KR; kk += 32) {
      unsigned bf[C::NT][2];
#pragma unroll
      for (int j = 0; j < C::NT; j += 2) {
        const int n = wn * C::WTN + 8 * j + lane % 8 + 8 * (lane / 16);
        unsigned r[4];
        ldsm_x4(r, tile + n * kLdt + kk + 16 * ((lane / 8) % 2));
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < C::MT; ++i) {
        if (wm * C::WTM + 16 * i >= npx) continue;   // no pixel in this m16
        unsigned af[4];
        if constexpr (FOLD) {
          // k = 4 dw + channel: a word of 4 channels a position, taps dw
          // = lane % 4 and 4 more of each of the lane's two pixels
          const unsigned* pw_ = reinterpret_cast<const unsigned*>(buf);
          const int o0 = base[i] + toff + lane % 4;
          const int o8 = base8[i] + toff + lane % 4;
          af[0] = pw_[o0];
          af[1] = pw_[o8];
          af[2] = pw_[o0 + 4];
          af[3] = pw_[o8 + 4];
        } else {
          ldsm_x4(af, buf + (base[i] + toff) * P.pitch + kk +
                          16 * (lane / 16));
        }
#pragma unroll
        for (int j = 0; j < C::NT; ++j)
          mma16832_s8(acc[i][j], af, bf[j][0], bf[j][1]);
      }
    }
  };
  stage_ring<kConvStages>(nt, load, compute);

  // the epilogue: pairs of neighbouring channels of each accumulator row
  const int pw0 = wm * C::WTM, nw = co0 + wn * C::WTN;
  const bool whole = gridDim.z == 1, vec2 = g.C_out % 2 == 0;
  int* plane = partial + (long long)blockIdx.z * g.N * g.Ho * g.Wo * g.C_out;
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = pw0 + 16 * i + lane / 4 + 8 * h;
      const int n = n0 + p / box_px, oh = oh0 + p / g.tw % g.th;
      const int ow = ow0 + p % g.tw;
      if (p >= npx || n >= g.N || oh >= g.Ho || ow >= g.Wo) continue;
      const long long m = ((long long)n * g.Ho + oh) * g.Wo + ow;
#pragma unroll
      for (int j = 0; j < C::NT; ++j) {
        const int co = nw + 8 * j + 2 * (lane % 4);
        if (co >= g.C_out) continue;
        const bool two = co + 1 < g.C_out;
        const int a0 = acc[i][j][2 * h], a1 = acc[i][j][2 * h + 1];
        const long long o = m * g.C_out + co;
        if (!whole) {
          store2(plane + o, a0, a1, two, vec2);
          continue;
        }
        const float f0 = __fmul_rn(__int2float_rn(a0), scale[co]);
        const float f1 = two ? __fmul_rn(__int2float_rn(a1), scale[co + 1])
                             : 0.f;
        if (g.out_bf16)
          store2(static_cast<bf16*>(out) + o, f0, f1, two, vec2);
        else
          store2(static_cast<float*>(out) + o, f0, f1, two, vec2);
      }
    }
}

template <int BN, int KR, bool FOLD>
int launch(const int8_t* x, const int8_t* w, const float* scale,
           int* partial, void* out, const QConvArgs& g, int ksplit, int smem,
           cudaStream_t stream) {
  static int attr = 0;   // the dynamic shared memory granted so far
  if (smem > attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        qconv_tc<BN, KR, FOLD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    attr = smem;
  }
  const int boxes = (g.N + g.ni - 1) / g.ni * ((g.Ho + g.th - 1) / g.th) *
                    ((g.Wo + g.tw - 1) / g.tw);
  const dim3 grid(boxes, (g.C_out + BN - 1) / BN, ksplit);
  qconv_tc<BN, KR, FOLD><<<grid, kTcThreads, smem, stream>>>(
      x, w, scale, partial, out, g);
  if (ksplit > 1) {
    const long long MN = (long long)g.N * g.Ho * g.Wo * g.C_out;
    if (g.out_bf16)
      launch_split_k_sum<quant_im2col_conv_tag, bf16>(
          partial, scale, static_cast<bf16*>(out), g.C_out, MN, ksplit,
          stream);
    else
      launch_split_k_sum<quant_im2col_conv_tag, float>(
          partial, scale, static_cast<float*>(out), g.C_out, MN, ksplit,
          stream);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, H, W, C_in), w (kh, kw, C_in, C_out) int8, scale (C_out,) float32,
// out (N, H_out, W_out, C_out) float32 or (out_bf16 = 1) bfloat16, all
// contiguous.  args holds the 21 ints {N, H, W, C_in, kh, kw, C_out, sh,
// sw, pt, pl, H_out, W_out, ni, th, tw, ck, bn, cpc, ksplit, out_bf16}
// (one host array).  Padding is (pt, pl) at the top / left; the bottom and
// right padding are implied by H_out / W_out.  The tile, as the wrapper's
// planner gives it: the pixel box ni x th x tw (at most 128 pixels), ck
// channels per chunk (32 or 64; 4 folds a stem of C_in <= 4), bn output
// channels per CTA (32, 64 or 128), the chunks split over ksplit CTAs of
// cpc each; partial (ksplit, N * H_out * W_out, C_out) int32 scratch
// (unused when ksplit == 1).
extern "C" int quant_im2col_conv(const int8_t* x, const int8_t* w,
                                 const float* scale, int* partial, void* out,
                                 const int* args, cudaStream_t stream) {
  const int N = args[0], H = args[1], W = args[2], C_in = args[3];
  const int kh = args[4], kw = args[5], C_out = args[6], sh = args[7];
  const int sw = args[8], pt = args[9], pl = args[10], H_out = args[11];
  const int W_out = args[12], ni = args[13], th = args[14], tw = args[15];
  const int ck = args[16], bn = args[17], cpc = args[18], ksplit = args[19];
  const int out_bf16 = args[20];
  const int nch = ck > 0 ? (C_in + ck - 1) / ck : 0;
  if (N < 1 || H < 1 || W < 1 || C_in < 1 || kh < 1 || kw < 1 ||
      C_out < 1 || sh < 1 || sw < 1 || H_out < 1 || W_out < 1 || ni < 1 ||
      th < 1 || tw < 1 || ni * th * tw > kConvRows ||
      (ck != 32 && ck != 64 && !(ck == 4 && C_in <= 4)) ||
      (bn != 32 && bn != 64 && bn != 128) ||
      cpc < 1 || ksplit < 1 || ksplit > 65535 ||
      (long long)cpc * ksplit < nch || (long long)cpc * (ksplit - 1) >= nch ||
      (C_out + bn - 1) / bn > 65535 || (ksplit > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool fold = ck == 4;
  const int T = fold ? kh : kh * kw;
  const int vec = C_in % 16 == 0 && C_out % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(w) % 16 == 0;
  QConvArgs g{N,  H,  W,      C_in,  kh, kw, C_out, sh, sw, pt, pl,
              H_out, W_out, ni, th,   tw, ck, cpc,   0,  vec, out_bf16};
  // the patches the ring loads ahead while a chunk's taps still read theirs
  g.nb = std::min(cpc, 1 + (kConvStages - 1 + T - 1) / T);
  const long long smem = qconv_smem(g, bn);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const int s = (int)smem;
  auto go = [&](auto BN) {
    constexpr int bn_ = decltype(BN)::value;
    if (fold)
      return launch<bn_, 32, true>(x, w, scale, partial, out, g, ksplit, s,
                                   stream);
    return ck == 64 ? launch<bn_, 64, false>(x, w, scale, partial, out, g,
                                             ksplit, s, stream)
                    : launch<bn_, 32, false>(x, w, scale, partial, out, g,
                                             ksplit, s, stream);
  };
  if (bn == 32) return go(std::integral_constant<int, 32>());
  return bn == 64 ? go(std::integral_constant<int, 64>())
                  : go(std::integral_constant<int, 128>());
}

// The constants the wrapper's planner (im2col_conv.py: conv_plan) sizes
// the int8 tile and its shared memory by, for it to check once at load:
// pixels per CTA, weight stages, plane pad (bytes), a folded patch's slack
// (bytes), the K-major tile's row pad (bytes).
extern "C" void quant_im2col_conv_tiles(int* t) {
  t[0] = kConvRows;
  t[1] = kConvStages;
  t[2] = kPlanePad;
  t[3] = kFoldSlack;
  t[4] = kTilePad;
}

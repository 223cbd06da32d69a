// The second pass of the split-K GeMMs and convs: out = (the sum of the
// partial planes, in plane order) * scale[col] where a column scale is
// given, rounded once to the output type.  The order is fixed and there
// are no atomics, so the result is deterministic.  Planes are float32, or
// int32 (the int8 GeMM's), which are summed in int32 -- exactly -- and
// cast to float32 once before the scale, as the reference's epilogue
// acc.astype(f32) * scale.
#pragma once

#include <cuda_runtime.h>

#include "dtypes.cuh"

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int x) { return __int2float_rn(x); }

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ int2 load2(const int* p) {
  return *reinterpret_cast<const int2*>(p);
}

// an int32 plane's pair, as store2 in dtypes.cuh
__device__ __forceinline__ void store2(int* out, int a, int b, bool two,
                                       bool vec) {
  if (two && vec) {
    *reinterpret_cast<int2*>(out) = make_int2(a, b);
  } else {
    out[0] = a;
    if (two) out[1] = b;
  }
}

// partial (planes, M, N) of TP (float or int), MN = M * N, scale (N,)
// float32 or null; two neighbouring outputs a thread.  Tag is an empty
// type named after the calling kernel, so that a profile puts each
// instance in its group.
template <typename Tag, typename TO, typename TP>
__global__ void split_k_sum(const TP* __restrict__ partial,
                            const float* __restrict__ scale,
                            TO* __restrict__ out, int N, long long MN,
                            int planes) {
  const long long i =
      2 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= MN) return;
  const bool two = i + 1 < MN, vec = MN % 2 == 0;
  TP s0 = 0, s1 = 0;
#pragma unroll 4
  for (int j = 0; j < planes; ++j) {  // loads overlap; sums in plane order
    const TP* p = partial + (long long)j * MN + i;
    if (vec) {
      const auto v = load2(p);
      s0 += v.x;
      s1 += v.y;
    } else {
      s0 += p[0];
      if (two) s1 += p[1];
    }
  }
  float f0 = to_f32(s0), f1 = to_f32(s1);
  if (scale != nullptr) {
    f0 = __fmul_rn(f0, scale[i % N]);
    if (two) f1 = __fmul_rn(f1, scale[(i + 1) % N]);
  }
  store2(out + i, f0, f1, two, vec);
}

template <typename Tag, typename TO, typename TP>
void launch_split_k_sum(const TP* partial, const float* scale, TO* out,
                        int N, long long MN, int planes,
                        cudaStream_t stream) {
  split_k_sum<Tag, TO, TP><<<(unsigned)((MN + 511) / 512), 256, 0,
                             stream>>>(partial, scale, out, N, MN, planes);
}

// The streaming GEMVs' split-K sum inside their own launch (gemv.cu,
// wq_gemv.cuh).  Every CTA of a column block has written its float32
// partial sums to its plane of `planes` (`plane` floats apart) before it
// calls this; every thread of the CTA calls it.  The CTA counts its
// arrival on `counter`, its column block's (zero between launches), after
// a __threadfence that publishes its plane; the last CTA to arrive sums
// the planes, in plane order, at each of this thread's kPer offsets `at`
// that are `live`, into `sum`, sets the counter back to zero and returns
// true.  The order is fixed and no atomic touches an output, so the
// result does not depend on which CTA came last.  Every other CTA returns
// false.  `flag`: one int of the CTA's shared memory.
template <int kPer>
__device__ __forceinline__ bool split_k_last_sum(
    const float* __restrict__ planes, long long plane, int ksplit,
    int* __restrict__ counter, int* flag, const long long (&at)[kPer],
    const bool (&live)[kPer], float (&sum)[kPer]) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(counter, 1) == ksplit - 1;
  __syncthreads();
  if (!*flag) return false;
  __threadfence();
  constexpr int kPlanes = 8;   // planes' loads in flight before their adds
#pragma unroll
  for (int e = 0; e < kPer; ++e) sum[e] = 0.f;
  for (int p0 = 0; p0 < ksplit; p0 += kPlanes) {
    float pv[kPlanes][kPer];
#pragma unroll
    for (int q = 0; q < kPlanes; ++q)
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        pv[q][e] = p0 + q < ksplit && live[e]
                       ? __ldcg(planes + (long long)(p0 + q) * plane + at[e])
                       : 0.f;
#pragma unroll
    for (int q = 0; q < kPlanes; ++q)
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        if (p0 + q < ksplit) sum[e] += pv[q][e];
  }
  if (threadIdx.x == 0) *counter = 0;  // ready for the next launch
  return true;
}

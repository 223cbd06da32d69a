// The second pass of every split-K kernel: out = (the sum of the float32
// partial planes, in plane order) * scale[col] where a column scale is
// given, rounded once to the output type.  The order is fixed and there
// are no atomics, so the result is deterministic.
#pragma once

#include <cuda_runtime.h>

#include "dtypes.cuh"

// partial (planes, M, N) float32, MN = M * N, scale (N,) float32 or null;
// two neighbouring outputs a thread.  Tag is an empty type named after
// the calling kernel, so that a profile puts each instance in its group.
template <typename Tag, typename TO>
__global__ void split_k_sum(const float* __restrict__ partial,
                            const float* __restrict__ scale,
                            TO* __restrict__ out, int N, long long MN,
                            int planes) {
  const long long i =
      2 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= MN) return;
  const bool two = i + 1 < MN, vec = MN % 2 == 0;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll 4
  for (int j = 0; j < planes; ++j) {  // loads overlap; sums in plane order
    const float* p = partial + (long long)j * MN + i;
    if (vec) {
      const float2 v = *reinterpret_cast<const float2*>(p);
      s0 += v.x;
      s1 += v.y;
    } else {
      s0 += p[0];
      if (two) s1 += p[1];
    }
  }
  if (scale != nullptr) {
    s0 = __fmul_rn(s0, scale[i % N]);
    if (two) s1 = __fmul_rn(s1, scale[(i + 1) % N]);
  }
  store2(out + i, s0, s1, two, vec);
}

template <typename Tag, typename TO>
void launch_split_k_sum(const float* partial, const float* scale, TO* out,
                        int N, long long MN, int planes,
                        cudaStream_t stream) {
  split_k_sum<Tag, TO><<<(unsigned)((MN + 511) / 512), 256, 0, stream>>>(
      partial, scale, out, N, MN, planes);
}

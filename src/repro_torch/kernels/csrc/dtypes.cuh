// The float kernels' operand and output types: float32 or bfloat16.
// Operands widen to float32 at the load (exact for bfloat16), sums stay in
// float32, and the epilogue rounds once to the output type.
#pragma once

#include <cuda_bf16.h>

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 narrow<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// out[0] = a and, where `two`, out[1] = b: one 2-element store when `vec`
// (out is then 2-element aligned), else one or two scalar ones
__device__ __forceinline__ void store2(float* out, float a, float b, bool two,
                                       bool vec) {
  if (two && vec) {
    *reinterpret_cast<float2*>(out) = make_float2(a, b);
  } else {
    out[0] = a;
    if (two) out[1] = b;
  }
}

__device__ __forceinline__ void store2(bf16* out, float a, float b, bool two,
                                       bool vec) {
  if (two && vec) {
    *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(a, b);
  } else {
    out[0] = __float2bfloat16_rn(a);
    if (two) out[1] = __float2bfloat16_rn(b);
  }
}

// FN<TI, TO>(...) for the operand type (in_bf16) and output type (out_bf16)
// that the C entry's flags name.
#define IO_DISPATCH(in_bf16, out_bf16, FN, ...)                          \
  ((in_bf16) ? ((out_bf16) ? FN<bf16, bf16>(__VA_ARGS__)                 \
                           : FN<bf16, float>(__VA_ARGS__))               \
             : ((out_bf16) ? FN<float, bf16>(__VA_ARGS__)                \
                           : FN<float, float>(__VA_ARGS__)))

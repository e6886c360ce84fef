// The training BatchNorm's normalised value as the plain path computes it,
// shared by K6's masked mode (bn_pair_sums.cu) and K13/K14 (bn_apply.cu):
//
//   y = round_T(x * scale + shift)
//
// with the product and the sum each rounded by its own _rn intrinsic
// (never contracted into an FMA: eager PyTorch runs them as two ops), then
// rounded to the tensor's dtype as .to() rounds on the card
// (__float2bfloat16_rn, the cast c10::BFloat16 makes on sm_80 and later).
// ReLU's output is closed where y <= 0: threshold_backward zeroes the
// gradient there (and passes it where y is NaN, as here).

#pragma once

#include <cuda_bf16.h>

template <typename T>
__device__ __forceinline__ float bn_round(float v);

template <>
__device__ __forceinline__ float bn_round<float>(float v) {
    return v;
}

template <>
__device__ __forceinline__ float bn_round<__nv_bfloat16>(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ float bn_value(float x, float scale, float shift) {
    return bn_round<T>(__fadd_rn(__fmul_rn(x, scale), shift));
}

template <typename T>
__device__ __forceinline__ bool relu_closed(float x, float scale,
                                            float shift) {
    return bn_value<T>(x, scale, shift) <= 0.0f;
}

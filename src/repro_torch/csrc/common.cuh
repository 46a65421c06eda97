// Shared helpers of the hand-written Hopper kernels: element loads and
// stores for the two input types, and the masking constants that the
// kernels share with their plain versions in kernels/ref.py.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Finite "minus infinity" of the masked logits. A row whose running max
// is still below NEG_INF / 2 has never seen an attendable key.
#define REPRO_NEG_INF (-1e30f)

// Input type codes passed from Python: 0 = float32, 1 = bfloat16.
enum ReproDtype { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

__device__ __forceinline__ float softcap_f32(float s, float cap) {
  return cap != 0.0f ? cap * tanhf(s / cap) : s;
}

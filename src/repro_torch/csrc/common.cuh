// Shared helpers of the attention kernels: element conversion and the
// numeric constants of the Pallas reference (repro/kernels/*.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

// masked logits get this value, as in the Pallas kernels; keys past the
// end of the tensor get -inf so that they weigh exactly 0 in every row
constexpr float NEG_INF = -1073741824.0f;  // -2**30

enum Dtype : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

__device__ __forceinline__ float apply_softcap(float s, float cap) {
  return cap != 0.f ? cap * tanhf(s / cap) : s;
}

}  // namespace repro

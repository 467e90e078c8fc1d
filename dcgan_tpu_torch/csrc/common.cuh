// Shared device helpers for the dcgan_tpu_torch kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dcgan {

// dtype codes passed by the Python wrappers (ops/kernels.py::_DTYPE_CODES)
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

// activation codes, in the order of ops/activations.py::ACTS
enum Act : int { kNone = 0, kRelu = 1, kLrelu = 2, kTanh = 3 };

// act(u) in f32. relu/lrelu are maxima written so that a NaN propagates,
// as jnp.maximum / torch.maximum do (fmaxf would drop it).
__device__ __forceinline__ float apply_act(float u, int act, float leak) {
  switch (act) {
    case kRelu: return u < 0.f ? 0.f : u;
    case kLrelu: { float v = leak * u; return u < v ? v : u; }
    case kTanh: return tanhf(u);
    default: return u;
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

}  // namespace dcgan

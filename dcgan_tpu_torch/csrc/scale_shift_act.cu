// scale_shift_act: y[n, c] = act(x[n, c] * scale[c] + shift[c])
//
// Replaces the TPU kernel `_ssa_fwd_kernel` (dcgan_tpu/ops/pallas_kernels.py,
// launched by `_ssa_impl` through pl.pallas_call). It is the BatchNorm
// epilogue of the generator's `bn0` under `use_pallas`: x is the [16B, 512]
// projection in the compute dtype, scale/shift are f32 [C] vectors folded
// from the running statistics, y has x's dtype.
//
// Bound: bytes. One read of x and one write of y, 2 x N x C x sizeof(x),
// plus the two [C] vectors; 3 flops per element is far below the card's
// ~20 flops/byte balance point. At B=64 (N=1024, C=512, bf16) that is 2 MB,
// about 0.6 us at 3.35 TB/s, well under the launch latency.
//
// Design: one elementwise pass. Each thread moves 16 bytes (8 bf16 or 4 f32)
// per load/store when C is a multiple of that width and the pointers are
// 16-byte aligned, so a warp touches 512 contiguous bytes; otherwise a
// scalar grid-stride loop handles any shape. The math is f32, the output
// rounds once to x's dtype, matching the TPU kernel.

#include <cstdint>

#include "common.cuh"

namespace {

using dcgan::apply_act;
using dcgan::from_float;
using dcgan::to_float;

template <typename T, int VEC>
__global__ void ssa_vec_kernel(const T* __restrict__ x,
                               const float* __restrict__ scale,
                               const float* __restrict__ shift,
                               T* __restrict__ y, int64_t n_vec, int c,
                               int act, float leak) {
  struct alignas(16) Pack { T v[VEC]; };
  const Pack* xv = reinterpret_cast<const Pack*>(x);
  Pack* yv = reinterpret_cast<Pack*>(y);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec;
       i += stride) {
    Pack in = xv[i];
    Pack out;
    // C % VEC == 0, so the VEC elements of a pack share one row
    const int c0 = (int)((i * VEC) % c);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float u = to_float(in.v[j]) * __ldg(scale + c0 + j) + __ldg(shift + c0 + j);
      out.v[j] = from_float<T>(apply_act(u, act, leak));
    }
    yv[i] = out;
  }
}

template <typename T>
__global__ void ssa_scalar_kernel(const T* __restrict__ x,
                                  const float* __restrict__ scale,
                                  const float* __restrict__ shift,
                                  T* __restrict__ y, int64_t numel, int c,
                                  int act, float leak) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < numel;
       i += stride) {
    const int ch = (int)(i % c);
    float u = to_float(x[i]) * scale[ch] + shift[ch];
    y[i] = from_float<T>(apply_act(u, act, leak));
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, const float* shift,
                   void* y, int64_t n, int c, int act, float leak,
                   cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int kThreads = 256;
  const int64_t numel = n * (int64_t)c;
  const bool aligned = (c % VEC == 0) &&
                       ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(y)) % 16 == 0);
  const int64_t work = aligned ? numel / VEC : numel;
  // enough blocks to cover the work, capped; the loops are grid-stride
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  if (aligned) {
    ssa_vec_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), scale, shift, static_cast<T*>(y), work, c,
        act, leak);
  } else {
    ssa_scalar_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), scale, shift, static_cast<T*>(y), numel, c,
        act, leak);
  }
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes. Returns a cudaError_t (0 = the launch was
// accepted). dtype: 0 = float32, 1 = bfloat16 (x and y share it).
extern "C" int dcgan_scale_shift_act(const void* x, const float* scale,
                                     const float* shift, void* y, int64_t n,
                                     int c, int dtype, int act, float leak,
                                     void* stream) {
  if (n <= 0 || c <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case dcgan::kFloat32:
      return (int)launch<float>(x, scale, shift, y, n, c, act, leak, s);
    case dcgan::kBFloat16:
      return (int)launch<__nv_bfloat16>(x, scale, shift, y, n, c, act, leak,
                                        s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

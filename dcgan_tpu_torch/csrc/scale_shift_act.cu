// scale_shift_act and its backward, the BatchNorm epilogue of the
// `use_pallas` and `pallas_fused` routes:
//
//   forward   y[n, c] = act(u),  u = x[n, c] * scale[c] + shift[c]
//   backward  du = g * act'(u),  dx = du * scale,
//             dscale[c] = sum_n du * x,  dshift[c] = sum_n du
//
// The forward replaces the TPU kernel `_ssa_fwd_kernel`, the backward
// `_ssa_bwd_kernel` (dcgan_tpu/ops/pallas_kernels.py, launched by `_ssa_impl`
// and `_ssa_vjp_bwd` through pl.pallas_call). x, g, y and dx are [N, C] in
// the compute dtype; scale/shift are f32 [C] vectors folded from the batch
// or running statistics; dscale/dshift are f32 [C]. The math is f32 and each
// output rounds once, as in the TPU kernels.
//
// Shapes on the celeba64 training step at B = 64 (bf16): G bn0 [1024, 512];
// G stages [4096, 256], [16384, 128], [65536, 64]; D stages [16384, 128],
// [4096, 256], [1024, 512].
//
// Bound: bytes. The forward reads x and writes y (4 bytes per element in
// bf16), the backward reads x and g and writes dx (6 bytes per element);
// a few flops per element are far below the card's balance point. At
// [65536, 64] bf16 the backward moves 25 MB, 7.5 us at 3.35 TB/s; at bn0
// 3 MB, 0.9 us, under the launch latency.
//
// Design. The forward is one elementwise pass: each thread moves 16 bytes
// (8 bf16 or 4 f32) per load/store when C is a multiple of that width and
// the pointers are 16-byte aligned, so a warp touches 512 contiguous bytes;
// otherwise a scalar grid-stride loop handles any shape.
// The backward must also reduce over rows, which the TPU kernel did by
// accumulating in place across a sequential grid. Here it is the two-pass
// column reduction of common.cuh: 32 x 8-thread blocks over a 32-column
// strip and a row chunk write dx elementwise and their f32 partial sums of
// du * x and du, then one thread per column adds the chunks in a fixed
// order. No atomics: two launches give the same bits.
// u is rounded after the product and after the sum (common.cuh::affine), as
// the plain version's two ops round it, so act'(u) masks the same elements.
// Still to do for speed: vector loads in the backward.

#include <cstdint>

#include "common.cuh"

namespace {

using dcgan::affine;
using dcgan::apply_act;
using dcgan::from_float;
using dcgan::kColTile;
using dcgan::kRowPhases;
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
      const float u = affine(to_float(in.v[j]), __ldg(scale + c0 + j),
                             __ldg(shift + c0 + j));
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
    const float u = affine(to_float(x[i]), scale[ch], shift[ch]);
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

// backward pass 1: dx, and per-chunk partials of du * x and du
template <typename T>
__global__ void ssa_bwd_partial(const T* __restrict__ x,
                                const float* __restrict__ scale,
                                const float* __restrict__ shift,
                                const T* __restrict__ g, T* __restrict__ dx,
                                int64_t n, int c, int64_t rows, int chunks,
                                int act, float leak,
                                float* __restrict__ part) {
  const int col = blockIdx.x * kColTile + threadIdx.x;
  const int chunk = blockIdx.y;
  const int64_t r0 = (int64_t)chunk * rows;
  const int64_t r1 = r0 + rows < n ? r0 + rows : n;
  float ds = 0.f, dt = 0.f;
  if (col < c) {
    const float s = scale[col], t = shift[col];
    for (int64_t r = r0 + threadIdx.y; r < r1; r += kRowPhases) {
      const int64_t i = r * c + col;
      const float xf = to_float(x[i]);
      const float du =
          to_float(g[i]) * dcgan::act_grad(affine(xf, s, t), act, leak);
      dx[i] = from_float<T>(du * s);
      ds += du * xf;
      dt += du;
    }
  }
  dcgan::write_column_partials(ds, dt, part, chunk, chunks, col, c);
}

template <typename T>
cudaError_t launch_bwd(const void* x, const float* scale, const float* shift,
                       const void* g, void* dx, float* dscale, float* dshift,
                       float* part, int chunks, int64_t n, int c, int act,
                       float leak, cudaStream_t stream) {
  const dim3 grid((c + kColTile - 1) / kColTile, chunks);
  const dim3 block(kColTile, kRowPhases);
  ssa_bwd_partial<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), scale, shift, static_cast<const T*>(g),
      static_cast<T*>(dx), n, c, dcgan::rows_per_chunk(n, chunks), chunks,
      act, leak, part);
  dcgan::launch_finish(part, chunks, c, 1.f, dscale, dshift, stream);
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

// Row chunks of the backward's partial-sum pass; the caller allocates the
// f32 workspace part[2][chunks][c] with this.
extern "C" int dcgan_scale_shift_act_bwd_chunks(int64_t n, int c,
                                                int sm_count) {
  return dcgan::column_chunks(n, c, sm_count);
}

// The backward. x, g and dx share dtype (0 = float32, 1 = bfloat16);
// dscale and dshift are f32 [c]. Returns a cudaError_t.
extern "C" int dcgan_scale_shift_act_bwd(const void* x, const float* scale,
                                         const float* shift, const void* g,
                                         void* dx, float* dscale,
                                         float* dshift, float* part,
                                         int chunks, int64_t n, int c,
                                         int dtype, int act, float leak,
                                         void* stream) {
  if (n <= 0 || c <= 0) return (int)cudaSuccess;
  if (chunks < 1 || chunks > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case dcgan::kFloat32:
      return (int)launch_bwd<float>(x, scale, shift, g, dx, dscale, dshift,
                                    part, chunks, n, c, act, leak, s);
    case dcgan::kBFloat16:
      return (int)launch_bwd<__nv_bfloat16>(x, scale, shift, g, dx, dscale,
                                            dshift, part, chunks, n, c, act,
                                            leak, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

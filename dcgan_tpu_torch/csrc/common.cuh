// Shared device helpers for the dcgan_tpu_torch kernels.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dcgan {

// dtype codes passed by the Python wrappers (ops/kernels.py::DTYPE_CODES)
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

// act'(u) in f32, the JAX package's `act_grad`: relu u > 0 ? 1 : 0, lrelu
// u > 0 ? 1 : leak (both 0 / leak at u = 0 and at NaN), tanh 1 - tanh(u)^2
__device__ __forceinline__ float act_grad(float u, int act, float leak) {
  switch (act) {
    case kRelu: return u > 0.f ? 1.f : 0.f;
    case kLrelu: return u > 0.f ? 1.f : leak;
    case kTanh: { float t = tanhf(u); return 1.f - t * t; }
    default: return 1.f;
  }
}

// u = x * scale + shift rounded after the product and after the sum, as two
// PyTorch or XLA ops round it: a contracted FMA could flip the sign of a u
// near 0, and with it act'(u), against the plain version
__device__ __forceinline__ float affine(float x, float scale, float shift) {
  return __fadd_rn(__fmul_rn(x, scale), shift);
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

// ---------------------------------------------------------------------------
// Deterministic per-column reductions over [N, C].
//
// The TPU kernels accumulate a [1, C] sum in place across a sequential row
// grid. GPU blocks run in no order, so here each block writes its partial
// sums to an f32 workspace part[2][chunks][C] and a second pass adds the
// chunks in a fixed order: no atomics, so two runs give the same bits.
//
// Pass 1 blocks are 32 x 8 threads over a strip of 32 columns and a chunk
// of rows: thread (tx, ty) walks rows ty, ty + 8, ... of its chunk in
// column tx, then the 8 partials of a column are added in ty order.
// ---------------------------------------------------------------------------

constexpr int kColTile = 32;
constexpr int kRowPhases = 8;

// Row chunks for a [n, c] reduction: about two blocks per SM in all, at
// least 64 rows per chunk. The caller sizes part[2][chunks][c] with this.
inline int column_chunks(int64_t n, int c, int sm_count) {
  const int col_blocks = (c + kColTile - 1) / kColTile;
  int64_t chunks = (2 * (int64_t)sm_count) / col_blocks;
  const int64_t by_rows = (n + 63) / 64;
  if (chunks > by_rows) chunks = by_rows;
  if (chunks > 65535) chunks = 65535;  // gridDim.y
  return chunks < 1 ? 1 : (int)chunks;
}

// Rows per chunk: a multiple of kRowPhases covering n in `chunks` chunks
// (trailing chunks may be empty and then contribute zeros).
inline int64_t rows_per_chunk(int64_t n, int chunks) {
  const int64_t per = (n + chunks - 1) / chunks;
  return (per + kRowPhases - 1) / kRowPhases * kRowPhases;
}

// In a 32 x 8 block: add the kRowPhases partials (a, b) of each column in
// ty order and write them to part[0][chunk][col], part[1][chunk][col].
__device__ __forceinline__ void write_column_partials(float a, float b,
                                                      float* part, int chunk,
                                                      int chunks, int col,
                                                      int c) {
  __shared__ float red[2][kRowPhases][kColTile];
  const int tx = threadIdx.x, ty = threadIdx.y;
  red[0][ty][tx] = a;
  red[1][ty][tx] = b;
  __syncthreads();
  if (ty == 0 && col < c) {
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int p = 0; p < kRowPhases; ++p) {
      sa += red[0][p][tx];
      sb += red[1][p][tx];
    }
    part[(int64_t)chunk * c + col] = sa;
    part[((int64_t)chunks + chunk) * c + col] = sb;
  }
}

// Pass 2 (internal linkage: each kernel library carries its own copy):
// out_a[col] = scale * sum_p part[0][p][col] (p in order), and
// out_b likewise from part[1].
static __global__ void finish_column_partials(
    const float* __restrict__ part, int parts, int c, float scale,
    float* __restrict__ out_a, float* __restrict__ out_b) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= c) return;
  float sa = 0.f, sb = 0.f;
  for (int p = 0; p < parts; ++p) {
    sa += part[(int64_t)p * c + col];
    sb += part[((int64_t)parts + p) * c + col];
  }
  out_a[col] = sa * scale;
  out_b[col] = sb * scale;
}

static inline void launch_finish(const float* part, int parts, int c,
                                 float scale, float* out_a, float* out_b,
                                 cudaStream_t stream) {
  finish_column_partials<<<(c + 127) / 128, 128, 0, stream>>>(
      part, parts, c, scale, out_a, out_b);
}

}  // namespace dcgan

// Shared device helpers for the dcgan_tpu_torch kernels.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dcgan {

// dtype codes passed by the Python wrappers (ops/kernels.py::DTYPE_CODES)
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

// a pointer the 16-byte loads and stores of a vector design may use
inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

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

// ---------------------------------------------------------------------------
// One-launch reductions: the last block adds the partials.
//
// Each block (or each cluster's leader, channel_moments.cu) that writes
// partials into part[2][chunks][c] fences them and draws a ticket (atomicInc
// on one int32 per device and kernel, which wraps back to 0 at the last
// ticket, ready for the next launch). The block that draws the last ticket
// adds every chunk's partials. The atomic only decides which block finishes;
// the order of the sums is fixed by (chunks, c), so two launches give the
// same bits. Launches sharing a ticket must not overlap (the port launches
// on one stream).
// ---------------------------------------------------------------------------

constexpr int kFinishThreads = 256;   // threads of a block that finishes

__device__ __forceinline__ void add_to(float& a, float v) { a += v; }
__device__ __forceinline__ void add_to(float4& a, float4 v) {
  a.x += v.x;
  a.y += v.y;
  a.z += v.z;
  a.w += v.w;
}
__device__ __forceinline__ float scaled(float a, float s) { return a * s; }
__device__ __forceinline__ float4 scaled(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

// out[col] = scale * sum over the chunks p of part[p][col] for both halves
// of part[2][chunks][c], by the block's kFinishThreads threads, in units V
// of one column (float) or four (float4, where c % 4 == 0: 16-byte loads).
// Below kFinishThreads units, groups of `units` threads each add a
// contiguous run of chunks, and the groups' sums are added in group order;
// the order is fixed by (chunks, c) alone.
template <typename V>
__device__ void add_partials(const float* part, int chunks, int c,
                             float scale, float* out_a, float* out_b,
                             int tid) {
  __shared__ V red[2][kFinishThreads];
  constexpr int W = sizeof(V) / sizeof(float);
  const int units = c / W;
  const V* pa = reinterpret_cast<const V*>(part);
  const V* pb = reinterpret_cast<const V*>(part + (int64_t)chunks * c);
  V* oa = reinterpret_cast<V*>(out_a);
  V* ob = reinterpret_cast<V*>(out_b);
  V a = {}, b = {};
  if (units >= kFinishThreads) {
    for (int u = tid; u < units; u += kFinishThreads) {
      a = b = V{};
#pragma unroll 8
      for (int p = 0; p < chunks; ++p) {
        add_to(a, __ldcg(pa + (int64_t)p * units + u));
        add_to(b, __ldcg(pb + (int64_t)p * units + u));
      }
      oa[u] = scaled(a, scale);
      ob[u] = scaled(b, scale);
    }
    return;
  }
  const int groups = kFinishThreads / units;
  const int per = (chunks + groups - 1) / groups;
  const int grp = tid / units, u = tid % units;
  if (grp < groups) {
    const int p1 = min(chunks, (grp + 1) * per);
#pragma unroll 8
    for (int p = grp * per; p < p1; ++p) {
      add_to(a, __ldcg(pa + (int64_t)p * units + u));
      add_to(b, __ldcg(pb + (int64_t)p * units + u));
    }
  }
  red[0][tid] = a;
  red[1][tid] = b;
  __syncthreads();
  if (tid < units) {
    a = b = V{};
    for (int g = 0; g < groups; ++g) {
      add_to(a, red[0][g * units + tid]);
      add_to(b, red[1][g * units + tid]);
    }
    oa[tid] = scaled(a, scale);
    ob[tid] = scaled(b, scale);
  }
}

// Called by every thread of each of the launch's `takers` blocks once its
// partials are in part[2][chunks][c] (a block of kFinishThreads threads):
// the block that draws the last ticket adds the chunks' partials
// (add_partials) into out_a and out_b, times `scale`.
static __device__ void finish_if_last(const float* part, int chunks, int c,
                                      float scale, float* out_a,
                                      float* out_b, unsigned takers,
                                      unsigned* __restrict__ ticket) {
  __shared__ bool last;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  __threadfence();   // this thread's partials, device-wide ...
  __syncthreads();   // ... for every thread of the block, before the ticket
  if (tid == 0) last = atomicInc(ticket, takers - 1) == takers - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (c % 4 == 0)   // part, out_a and out_b are 16-byte aligned
    add_partials<float4>(part, chunks, c, scale, out_a, out_b, tid);
  else
    add_partials<float>(part, chunks, c, scale, out_a, out_b, tid);
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

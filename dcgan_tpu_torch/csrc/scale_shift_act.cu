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
// accumulating in place across a sequential grid. Here it is one launch in
// one of two designs; the plan (ops/kernels.py::ssa_bwd_design) picks one
// by shape and alignment, and the launch refuses a design it cannot run:
//   vector, where C is a multiple of 8 (bf16; 4 in f32), C / 8 <= 256 and
//   x, g and dx are 16-byte aligned (every celeba64 shape): each thread
//   owns 8 consecutive columns (4 in f32) and moves 16 bytes per load of x
//   and g and per store of dx, neighbouring threads on neighbouring
//   columns, so a warp touches 512 contiguous bytes; a 256-thread block
//   covers 256 * 8 / C rows per step over its chunk of rows, four rows'
//   loads in flight per thread; at most 2 blocks per SM, each walking at
//   least kBwdMinSteps steps, so that the partials stay few. Each thread
//   keeps f32 sums of du * x and du for its columns in registers, and the
//   block adds its rows' sums through shared memory in row order into
//   part[2][block][C];
//   scalar, any shape: 32 x 8-thread blocks over a 32-column strip and a
//   chunk of rows, one element per thread (common.cuh's column partials).
// The last block to finish adds every block's partials into dscale and
// dshift (16-byte loads where C % 4 == 0, thread groups over runs of
// blocks): each block fences its partials and draws a ticket (atomicInc on
// one int32 per device, which wraps back to 0 at the last ticket, ready
// for the next launch). The atomic only decides which block finishes; the
// order of the sums is fixed, so two launches give the same bits. Launches
// sharing the device's ticket must not overlap (the port launches on one
// stream). At small shapes the pass is latency-bound on few SMs and the
// ticket and the last block's reads add to it (PERF.md).
// u is rounded after the product and after the sum (common.cuh::affine), as
// the plain version's two ops round it, so act'(u) masks the same elements.

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

// ---------------------------------------------------------------------------
// The backward
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 256;
// each vector block walks at least this many steps of its rows, and
// issues the loads of kBwdRowsPerTurn steps before their math
constexpr int kBwdMinSteps = 8;
constexpr int kBwdRowsPerTurn = 4;
// ops/kernels.py::SSA_BWD_DESIGNS
enum BwdDesign : int { kBwdScalar = 0, kBwdVector = 1 };

// one element of the backward: dx, and du * x and du added to the sums
template <typename T>
__device__ __forceinline__ T bwd_element(T xv, T gv, float s, float t,
                                         int act, float leak, float& ds,
                                         float& dt) {
  const float xf = to_float(xv);
  const float du = to_float(gv) * dcgan::act_grad(affine(xf, s, t), act, leak);
  ds += du * xf;
  dt += du;
  return from_float<T>(du * s);
}

__device__ __forceinline__ void add_to(float& a, float v) { a += v; }
__device__ __forceinline__ void add_to(float4& a, float4 v) {
  a.x += v.x;
  a.y += v.y;
  a.z += v.z;
  a.w += v.w;
}

// out[col] = sum over the chunks p of part[p][col] for both halves of
// part[2][chunks][c], by the block's kBwdThreads threads, in units V of
// one column (float) or four (float4, where c % 4 == 0: 16-byte loads).
// Below kBwdThreads units, groups of `units` threads each add a contiguous
// run of chunks, and the groups' sums are added in group order; the order
// is fixed by (chunks, c) alone.
template <typename V>
__device__ void add_partials(const float* part, int chunks, int c,
                             float* out_a, float* out_b, int tid) {
  __shared__ V red[2][kBwdThreads];
  constexpr int W = sizeof(V) / sizeof(float);
  const int units = c / W;
  const V* pa = reinterpret_cast<const V*>(part);
  const V* pb = reinterpret_cast<const V*>(part + (int64_t)chunks * c);
  V* oa = reinterpret_cast<V*>(out_a);
  V* ob = reinterpret_cast<V*>(out_b);
  V a = {}, b = {};
  if (units >= kBwdThreads) {
    for (int u = tid; u < units; u += kBwdThreads) {
      a = b = V{};
#pragma unroll 8
      for (int p = 0; p < chunks; ++p) {
        add_to(a, __ldcg(pa + (int64_t)p * units + u));
        add_to(b, __ldcg(pb + (int64_t)p * units + u));
      }
      oa[u] = a;
      ob[u] = b;
    }
    return;
  }
  const int groups = kBwdThreads / units;
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
    oa[tid] = a;
    ob[tid] = b;
  }
}

// Called by every thread of every block once its partials are in
// part[2][chunks][c]: the block that draws the launch's last ticket adds
// the chunks' partials (add_partials) into out_a and out_b.
__device__ void finish_if_last(const float* part, int chunks, int c,
                               float* out_a, float* out_b,
                               unsigned* __restrict__ ticket) {
  __shared__ bool last;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const unsigned blocks = gridDim.x * gridDim.y;
  __threadfence();   // this thread's partials, device-wide ...
  __syncthreads();   // ... for every thread of the block, before the ticket
  if (tid == 0) last = atomicInc(ticket, blocks - 1) == blocks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (c % 4 == 0)   // part, out_a and out_b are 16-byte aligned
    add_partials<float4>(part, chunks, c, out_a, out_b, tid);
  else
    add_partials<float>(part, chunks, c, out_a, out_b, tid);
}

// The vector design (see the top of the file): block blockIdx.x walks rows
// [blockIdx.x * rows, + rows). C % VEC == 0 and C / VEC <= kBwdThreads.
template <typename T, int VEC>
__global__ void __launch_bounds__(kBwdThreads, 2)
    ssa_bwd_vec_kernel(const T* __restrict__ x,
                       const float* __restrict__ scale,
                       const float* __restrict__ shift,
                       const T* __restrict__ g, T* __restrict__ dx,
                       int64_t n, int c, int64_t rows, int act, float leak,
                       float* part, float* dscale, float* dshift,
                       unsigned* __restrict__ ticket) {
  struct alignas(16) Pack { T v[VEC]; };
  __shared__ float red[2][kBwdThreads * VEC];
  const int per_row = c / VEC;            // threads on one row
  const int step = kBwdThreads / per_row; // rows per step of the block
  const int tid = threadIdx.x;
  const int rp = tid / per_row;
  const int c0 = (tid % per_row) * VEC;
  float ds[VEC], dt[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) ds[e] = dt[e] = 0.f;
  if (rp < step) {   // (256 % per_row threads sit out)
    float s[VEC], t[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      s[e] = __ldg(scale + c0 + e);
      t[e] = __ldg(shift + c0 + e);
    }
    const Pack* xv = reinterpret_cast<const Pack*>(x);
    const Pack* gv = reinterpret_cast<const Pack*>(g);
    Pack* dxv = reinterpret_cast<Pack*>(dx);
    const int64_t r0 = (int64_t)blockIdx.x * rows;
    const int64_t r1 = r0 + rows < n ? r0 + rows : n;
    const int64_t next = (int64_t)step * per_row;   // packs one step down
    int64_t r = r0 + rp;
    // kBwdRowsPerTurn rows a turn: every row's loads are issued before
    // any row's math, then the rows one step apart
    for (; r + (kBwdRowsPerTurn - 1) * step < r1;
         r += kBwdRowsPerTurn * step) {
      const int64_t i0 = (r * c + c0) / VEC;
      Pack xs[kBwdRowsPerTurn], gs[kBwdRowsPerTurn];
#pragma unroll
      for (int q = 0; q < kBwdRowsPerTurn; ++q) {
        xs[q] = xv[i0 + q * next];
        gs[q] = gv[i0 + q * next];
      }
#pragma unroll
      for (int q = 0; q < kBwdRowsPerTurn; ++q) {
        Pack o;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          o.v[e] = bwd_element(xs[q].v[e], gs[q].v[e], s[e], t[e], act,
                               leak, ds[e], dt[e]);
        dxv[i0 + q * next] = o;
      }
    }
    for (; r < r1; r += step) {
      const int64_t i = (r * c + c0) / VEC;
      const Pack xa = xv[i], ga = gv[i];
      Pack o;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        o.v[e] = bwd_element(xa.v[e], ga.v[e], s[e], t[e], act, leak, ds[e],
                             dt[e]);
      dxv[i] = o;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      red[0][rp * c + c0 + e] = ds[e];
      red[1][rp * c + c0 + e] = dt[e];
    }
  }
  __syncthreads();
  // the block's partials: its rows' sums added in row-phase order
  for (int col = tid; col < c; col += kBwdThreads) {
    float a = 0.f, b = 0.f;
    for (int p = 0; p < step; ++p) {
      a += red[0][p * c + col];
      b += red[1][p * c + col];
    }
    part[(int64_t)blockIdx.x * c + col] = a;
    part[((int64_t)gridDim.x + blockIdx.x) * c + col] = b;
  }
  finish_if_last(part, gridDim.x, c, dscale, dshift, ticket);
}

// The scalar design: a 32-column strip (blockIdx.x) of a row chunk
// (blockIdx.y), one element per thread per row
template <typename T>
__global__ void ssa_bwd_scalar_kernel(const T* __restrict__ x,
                                      const float* __restrict__ scale,
                                      const float* __restrict__ shift,
                                      const T* __restrict__ g,
                                      T* __restrict__ dx, int64_t n, int c,
                                      int64_t rows, int act, float leak,
                                      float* part,
                                      float* __restrict__ dscale,
                                      float* __restrict__ dshift,
                                      unsigned* __restrict__ ticket) {
  const int col = blockIdx.x * kColTile + threadIdx.x;
  const int chunk = blockIdx.y;
  const int64_t r0 = (int64_t)chunk * rows;
  const int64_t r1 = r0 + rows < n ? r0 + rows : n;
  float ds = 0.f, dt = 0.f;
  if (col < c) {
    const float s = scale[col], t = shift[col];
    for (int64_t r = r0 + threadIdx.y; r < r1; r += kRowPhases) {
      const int64_t i = r * c + col;
      dx[i] = bwd_element(x[i], g[i], s, t, act, leak, ds, dt);
    }
  }
  dcgan::write_column_partials(ds, dt, part, chunk, gridDim.y, col, c);
  finish_if_last(part, gridDim.y, c, dscale, dshift, ticket);
}

template <typename T>
constexpr int vec_of() { return 16 / (int)sizeof(T); }

bool vector_fits(int c, int vec) {
  return c % vec == 0 && c / vec <= kBwdThreads;
}

// Blocks (vector) or row chunks (scalar) of a launch; the caller sizes
// part[2][chunks][c] with this.
int bwd_chunks(int64_t n, int c, int vec, int design, int sm_count) {
  if (design != kBwdVector) return dcgan::column_chunks(n, c, sm_count);
  if (!vector_fits(c, vec)) return 1;   // the launch refuses it
  const int64_t span = (int64_t)(kBwdThreads / (c / vec)) * kBwdMinSteps;
  int64_t blocks = (n + span - 1) / span;
  if (blocks > 2 * (int64_t)sm_count) blocks = 2 * (int64_t)sm_count;
  return blocks < 1 ? 1 : (int)blocks;
}

template <typename T>
cudaError_t launch_bwd(const void* x, const float* scale, const float* shift,
                       const void* g, void* dx, float* dscale, float* dshift,
                       float* part, unsigned* ticket, int design, int chunks,
                       int64_t n, int c, int act, float leak,
                       cudaStream_t stream) {
  constexpr int VEC = vec_of<T>();
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* dxt = static_cast<T*>(dx);
  if (design == kBwdVector) {
    const bool aligned =
        ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g) |
          reinterpret_cast<uintptr_t>(dx)) % 16) == 0;
    if (!aligned || !vector_fits(c, VEC)) return cudaErrorInvalidValue;
    ssa_bwd_vec_kernel<T, VEC><<<chunks, kBwdThreads, 0, stream>>>(
        xt, scale, shift, gt, dxt, n, c, (n + chunks - 1) / chunks, act,
        leak, part, dscale, dshift, ticket);
  } else if (design == kBwdScalar) {
    if (chunks > 65535) return cudaErrorInvalidValue;   // gridDim.y
    const dim3 grid((c + kColTile - 1) / kColTile, chunks);
    const dim3 block(kColTile, kRowPhases);
    ssa_bwd_scalar_kernel<T><<<grid, block, 0, stream>>>(
        xt, scale, shift, gt, dxt, n, c, dcgan::rows_per_chunk(n, chunks),
        act, leak, part, dscale, dshift, ticket);
  } else {
    return cudaErrorInvalidValue;
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

// Blocks (design 1, vector) or row chunks (design 0, scalar) of the
// backward's launch; the caller allocates the f32 workspace
// part[2][chunks][c] with this. dtype: 0 = float32, 1 = bfloat16.
extern "C" int dcgan_scale_shift_act_bwd_chunks(int64_t n, int c, int dtype,
                                                int design, int sm_count) {
  const int vec = dtype == dcgan::kFloat32 ? vec_of<float>()
                                           : vec_of<__nv_bfloat16>();
  return bwd_chunks(n, c, vec, design, sm_count);
}

// The backward, one launch. x, g and dx share dtype (0 = float32, 1 =
// bfloat16); dscale and dshift are f32 [c]; part is the workspace of
// `chunks` rows; ticket is the device's int32 counter, 0 between launches.
// design: 0 = scalar, 1 = vector (ops/kernels.py::ssa_bwd_design), refused
// with cudaErrorInvalidValue where it does not fit. Returns a cudaError_t.
extern "C" int dcgan_scale_shift_act_bwd(const void* x, const float* scale,
                                         const float* shift, const void* g,
                                         void* dx, float* dscale,
                                         float* dshift, float* part,
                                         void* ticket, int design,
                                         int chunks, int64_t n, int c,
                                         int dtype, int act, float leak,
                                         void* stream) {
  if (n <= 0 || c <= 0) return (int)cudaSuccess;
  if (chunks < 1 || ticket == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* t = static_cast<unsigned*>(ticket);
  switch (dtype) {
    case dcgan::kFloat32:
      return (int)launch_bwd<float>(x, scale, shift, g, dx, dscale, dshift,
                                    part, t, design, chunks, n, c, act, leak,
                                    s);
    case dcgan::kBFloat16:
      return (int)launch_bwd<__nv_bfloat16>(x, scale, shift, g, dx, dscale,
                                            dshift, part, t, design, chunks,
                                            n, c, act, leak, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

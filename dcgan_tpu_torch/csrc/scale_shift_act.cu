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
// [65536, 64] bf16 the forward moves 16.8 MB, 5.0 us at 3.35 TB/s, the
// backward 25 MB, 7.5 us; at bn0 the forward moves 2 MB, 0.6 us, under the
// launch latency.
//
// Why CUDA and not Triton: both directions fix which thread owns which
// columns and rows (the scale/shift registers, the backward's row order),
// and the backward's one-launch reduction needs an atomic ticket and a
// last-block finish; Triton's block model chooses neither.
//
// Design. Both directions come in two designs; the plan
// (ops/kernels.py::ssa_fwd_design, ::ssa_bwd_design) picks one by shape and
// alignment, and the launch refuses a design it cannot run:
//   vector, where C is a multiple of 8 (bf16; 4 in f32), C / 8 <= 256 and
//   the operands are 16-byte aligned (every celeba64 shape): each thread
//   owns 8 consecutive columns (4 in f32), loads their scale and shift once
//   (as float4s, in registers) and walks rows, moving 16 bytes per load of
//   x (and g) and per store of y (dx), neighbouring threads on neighbouring
//   columns, so a warp touches 512 contiguous bytes; a 256-thread block
//   covers 256 * 8 / C rows per step, and each thread issues the loads of
//   several steps before their math (kFwdRowsPerTurn, kBwdRowsPerTurn);
//   scalar, any shape: the forward is a grid-stride loop over elements, the
//   backward 32 x 8-thread blocks over a 32-column strip and a chunk of
//   rows (common.cuh's column partials).
// The forward is one elementwise pass: its vector blocks walk turns of
// kFwdRowsPerTurn row steps, turn t by block t % grid, a few blocks per SM
// (kFwdBlocksPerSm, from the SM count the wrapper passes); the activation
// is a template parameter, so relu, lrelu and none never reach tanhf.
// The backward must also reduce over rows, which the TPU kernel did by
// accumulating in place across a sequential grid. Here it is one launch:
// each vector block walks a chunk of at least kBwdMinSteps steps, at most
// 2 blocks per SM, so that the partials stay few; each thread keeps f32
// sums of du * x and du for its columns in registers, and the block adds
// its rows' sums through shared memory in row order into
// part[2][block][C]. The last block to finish adds every block's partials
// into dscale and dshift (common.cuh::finish_if_last: an atomic ticket,
// 16-byte loads where C % 4 == 0, thread groups over runs of blocks); the
// order of the sums is fixed by the shape, so two launches give the same
// bits. At small shapes the backward is latency-bound on few SMs and the
// ticket and the last block's reads add to it (PERF.md).
// What still holds the forward back: at 1-4 MB one launch's latency is
// most of its time; the bf16 rounding of u before it is a separate cast on
// the fused route (ops/fused.py).
// u is rounded after the product and after the sum (common.cuh::affine), as
// the plain version's two ops round it, so the forward matches it bit for
// bit except in tanh's last ulp, and act'(u) masks the same elements.

#include <cstdint>

#include "common.cuh"

namespace {

using dcgan::affine;
using dcgan::aligned16;
using dcgan::apply_act;
using dcgan::from_float;
using dcgan::kColTile;
using dcgan::kRowPhases;
using dcgan::to_float;

// ops/kernels.py::SSA_FWD_DESIGNS and SSA_BWD_DESIGNS
enum FwdDesign : int { kFwdScalar = 0, kFwdVector = 1 };
constexpr int kFwdThreads = 256;
// the row steps whose loads a vector thread issues before their math, and
// the resident blocks per SM the vector grid is sized for
constexpr int kFwdRowsPerTurn = 4;
constexpr int kFwdBlocksPerSm = 4;
// blocks per SM of the scalar grid-stride loop
constexpr int kScalarBlocksPerSm = 32;

// VEC consecutive floats from a 16-byte aligned address, as float4 loads
template <int VEC>
__device__ __forceinline__ void load_vector(const float* __restrict__ p,
                                            float (&out)[VEC]) {
  static_assert(VEC % 4 == 0, "whole float4s");
#pragma unroll
  for (int k = 0; k < VEC / 4; ++k) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p) + k);
    out[4 * k] = v.x;
    out[4 * k + 1] = v.y;
    out[4 * k + 2] = v.z;
    out[4 * k + 3] = v.w;
  }
}

// The forward's vector design (see the top of the file): C % VEC == 0,
// C / VEC <= kFwdThreads, x, y, scale and shift 16-byte aligned.
template <typename T, int VEC, int ACT>
__global__ void __launch_bounds__(kFwdThreads)
    ssa_fwd_vec_kernel(const T* __restrict__ x,
                       const float* __restrict__ scale,
                       const float* __restrict__ shift, T* __restrict__ y,
                       int64_t n, int c, float leak) {
  struct alignas(16) Pack { T v[VEC]; };
  const int per_row = c / VEC;             // threads on one row
  const int step = kFwdThreads / per_row;  // rows per step of the block
  const int rp = threadIdx.x / per_row;
  if (rp >= step) return;                  // (256 % per_row threads)
  const int cv = threadIdx.x % per_row;    // the thread's pack of a row
  float s[VEC], t[VEC];
  load_vector<VEC>(scale + cv * VEC, s);
  load_vector<VEC>(shift + cv * VEC, t);
  const Pack* xv = reinterpret_cast<const Pack*>(x);
  Pack* yv = reinterpret_cast<Pack*>(y);
  const int64_t span = (int64_t)kFwdRowsPerTurn * step;  // rows of a turn
  const int64_t next = (int64_t)step * per_row;          // packs one step
  for (int64_t r = (int64_t)blockIdx.x * span + rp; r < n;
       r += (int64_t)gridDim.x * span) {
    const int64_t i0 = r * per_row + cv;
    Pack in[kFwdRowsPerTurn];
#pragma unroll
    for (int q = 0; q < kFwdRowsPerTurn; ++q)
      if (r + q * step < n) in[q] = xv[i0 + q * next];
#pragma unroll
    for (int q = 0; q < kFwdRowsPerTurn; ++q) {
      if (r + q * step >= n) break;
      Pack out;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        out.v[e] = from_float<T>(
            apply_act(affine(to_float(in[q].v[e]), s[e], t[e]), ACT, leak));
      yv[i0 + q * next] = out;
    }
  }
}

template <typename T>
__global__ void ssa_fwd_scalar_kernel(const T* __restrict__ x,
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
constexpr int vec_of() { return 16 / (int)sizeof(T); }

template <typename T, int ACT>
void launch_fwd_vec(const T* x, const float* scale, const float* shift, T* y,
                    int64_t n, int c, float leak, int sm_count,
                    cudaStream_t stream) {
  constexpr int VEC = vec_of<T>();
  const int64_t span = (int64_t)kFwdRowsPerTurn * (kFwdThreads / (c / VEC));
  int64_t blocks = (n + span - 1) / span;
  if (blocks > (int64_t)kFwdBlocksPerSm * sm_count)
    blocks = (int64_t)kFwdBlocksPerSm * sm_count;
  ssa_fwd_vec_kernel<T, VEC, ACT><<<(unsigned)blocks, kFwdThreads, 0,
                                     stream>>>(x, scale, shift, y, n, c,
                                               leak);
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, const float* shift,
                   void* y, int64_t n, int c, int act, float leak, int design,
                   int sm_count, cudaStream_t stream) {
  constexpr int VEC = vec_of<T>();
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (sm_count < 1) return cudaErrorInvalidValue;
  if (design == kFwdVector) {
    if (c % VEC != 0 || c / VEC > kFwdThreads ||
        !aligned16(x) || !aligned16(y) || !aligned16(scale) ||
        !aligned16(shift))
      return cudaErrorInvalidValue;
    switch (act) {
      case dcgan::kNone:
        launch_fwd_vec<T, dcgan::kNone>(xt, scale, shift, yt, n, c, leak,
                                        sm_count, stream);
        break;
      case dcgan::kRelu:
        launch_fwd_vec<T, dcgan::kRelu>(xt, scale, shift, yt, n, c, leak,
                                        sm_count, stream);
        break;
      case dcgan::kLrelu:
        launch_fwd_vec<T, dcgan::kLrelu>(xt, scale, shift, yt, n, c, leak,
                                         sm_count, stream);
        break;
      case dcgan::kTanh:
        launch_fwd_vec<T, dcgan::kTanh>(xt, scale, shift, yt, n, c, leak,
                                        sm_count, stream);
        break;
      default:
        return cudaErrorInvalidValue;
    }
  } else if (design == kFwdScalar) {
    const int64_t numel = n * (int64_t)c;
    int64_t blocks = (numel + kFwdThreads - 1) / kFwdThreads;
    if (blocks > (int64_t)kScalarBlocksPerSm * sm_count)
      blocks = (int64_t)kScalarBlocksPerSm * sm_count;
    ssa_fwd_scalar_kernel<T><<<(unsigned)blocks, kFwdThreads, 0, stream>>>(
        xt, scale, shift, yt, numel, c, act, leak);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The backward
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 256;
static_assert(kBwdThreads == dcgan::kFinishThreads,
              "every block of the backward may finish the launch");
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
  dcgan::finish_if_last(part, gridDim.x, c, 1.f, dscale, dshift, gridDim.x,
                        ticket);
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
  dcgan::finish_if_last(part, gridDim.y, c, 1.f, dscale, dshift,
                        gridDim.x * gridDim.y, ticket);
}

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
    if (!aligned16(x) || !aligned16(g) || !aligned16(dx) ||
        !vector_fits(c, VEC))
      return cudaErrorInvalidValue;
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
// accepted). dtype: 0 = float32, 1 = bfloat16 (x and y share it). design:
// 0 = scalar, 1 = vector (ops/kernels.py::ssa_fwd_design), refused with
// cudaErrorInvalidValue where it does not fit; sm_count sizes the grid.
extern "C" int dcgan_scale_shift_act(const void* x, const float* scale,
                                     const float* shift, void* y, int64_t n,
                                     int c, int dtype, int act, float leak,
                                     int design, int sm_count, void* stream) {
  if (n <= 0 || c <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case dcgan::kFloat32:
      return (int)launch<float>(x, scale, shift, y, n, c, act, leak, design,
                                sm_count, s);
    case dcgan::kBFloat16:
      return (int)launch<__nv_bfloat16>(x, scale, shift, y, n, c, act, leak,
                                        design, sm_count, s);
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
// `chunks` rows; ticket is an int32 counter of this kernel's own, 0
// between launches.
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

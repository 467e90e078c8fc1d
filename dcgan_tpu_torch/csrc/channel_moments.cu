// channel_moments: mean[c] = sum_n x[n, c] / N, mean_sq[c] = sum_n x^2 / N
//
// Replaces the TPU kernel `_moments_kernel` (dcgan_tpu/ops/pallas_kernels.py,
// launched by `_moments_fwd_impl` through pl.pallas_call). It is the batch
// statistics of BatchNorm's train path under `use_pallas`: on the celeba64
// training step, G's `bn0` over the [16 B, 512] projection in the compute
// dtype (2 launches per step); on the `use_pallas`-only route also every
// interior BN, up to [65536, 64]. Both outputs are f32 and the sums are
// multiplied by 1/N once at the end, as the TPU kernel's wrapper does.
//
// Bound: bytes, and at bn0 in practice launch latency. One read of x: at
// B = 64 (N = 1024, C = 512, bf16) 1 MB, 0.3 us at 3.35 TB/s; [65536, 64]
// bf16 8.4 MB, 2.5 us. Two FMAs per element are far below the card's
// compute.
//
// Design: one launch. The TPU kernel accumulates a [1, C] sum in place
// across a sequential row grid; GPU blocks run in no order, so the blocks
// that share a column strip reduce through a thread block cluster:
//   - Each 256-thread CTA works on a strip of columns: each thread owns 8
//     consecutive columns in bf16 (4 in f32; 1 in the scalar design) and
//     moves 16 bytes per load, kStripVector threads across the strip
//     (kStripScalar in the scalar design), so a warp reads 256 contiguous
//     bytes of each of two rows. It walks its rows one step of 256 /
//     threads-across rows at a time, issuing kRowsPerTurn steps' loads
//     before their math, and sums x and x^2 in f32 registers.
//   - The kCluster CTAs of one cluster share the strip and split its rows in
//     order. Each adds its threads' sums in row order in shared memory and
//     stores them into CTA rank 0's shared memory through distributed
//     shared memory; after a cluster barrier (release, acquire) rank 0 adds
//     them in rank order. The barrier phase that shows every CTA of the
//     cluster running, which must come before the stores, is arrived at
//     before the loads and waited on after them, so its latency hides
//     behind theirs.
//   - One cluster per strip holds all of its rows where the plan
//     (ops/kernels.py::moments_plan) gives one group (bn0, and every shape
//     up to kCluster * kRowsPerTurn row steps): rank 0 scales by 1/N and
//     writes mean and mean_sq. Above that, one cluster per strip cannot
//     stream at full rate, so `groups` clusters per strip (at most
//     kCtasPerSm CTAs per SM in all) each write one partial and the last
//     cluster leader to finish adds them (common.cuh::finish_if_last: an
//     atomic ticket and a float4 finish), at most ~17 partials per column.
// Every sum's order is fixed by the shape and the plan: no atomics add,
// so two launches give the same bits. The vector design needs C % 8 == 0
// (bf16; 4 in f32) and a 16-byte aligned x; the scalar design takes any
// shape. The launch refuses a design it cannot run.
// Why CUDA and not Triton: the design fixes which thread owns which rows
// and columns and reduces across CTAs through clusters and distributed
// shared memory, which Triton does not expose.
// What still holds it back (PERF.md): at bn0, the launch and one turn of
// loads, then the row-phase sums through shared memory and the cluster
// barrier after the stores into rank 0, all latency, ~14x the bytes'
// bound; above one group, the ticket and the last leader's reads as well,
// the same ~0.008 ms floor as scale_shift_act's backward.

#include <cstdint>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using dcgan::to_float;

// ops/kernels.py::MOMENTS_DESIGNS and the plan's constants
enum MomentsDesign : int { kMomentsScalar = 0, kMomentsVector = 1 };
constexpr int kThreads = 256;
constexpr int kCluster = 16;        // CTAs per cluster (non-portable above 8)
constexpr int kStripVector = 16;    // threads across a strip, vector design
constexpr int kStripScalar = 32;    // threads across a strip, scalar design
constexpr int kRowsPerTurn = 4;     // row steps whose loads go out together
constexpr int kCtasPerSm = 2;       // the plan's cap on CTAs of the grid
constexpr int kMaxStripCols = 128;  // kStripVector * 8 bf16 columns
static_assert(kThreads == dcgan::kFinishThreads,
              "a cluster leader may finish the launch");
static_assert(kStripScalar <= kMaxStripCols, "the scalar strip fits");

// The cluster barrier in its two halves (PTX barrier.cluster): arrive
// without ordering memory, arrive with release semantics, and wait (with
// acquire semantics). Every thread of every CTA of the cluster arrives once
// and waits once per phase.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// CTA (blockIdx.x % kCluster) of cluster (blockIdx.x / kCluster) on strip
// blockIdx.y; VEC columns per thread (1 in the scalar design), `sw` threads
// across the strip, `rows` rows per CTA. groups = gridDim.x / kCluster: one
// group writes mean and mean_sq, more write part[2][groups][c] first.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    moments_cluster_kernel(const T* __restrict__ x, int64_t n, int c, int sw,
                           int64_t rows, float inv_n, float* mean,
                           float* mean_sq, float* part,
                           unsigned* __restrict__ ticket) {
  struct alignas(sizeof(T) * VEC) Pack { T v[VEC]; };
  __shared__ float red[2][kThreads * VEC];
  // rank 0's: every CTA's column sums, by rank
  __shared__ float gather[kCluster][2][kMaxStripCols];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  // the first phase shows that every CTA of the cluster runs (so that
  // rank 0's shared memory may be written); its wait comes after the loads
  cluster_arrive_relaxed();
  const int group = blockIdx.x / kCluster;
  const int groups = gridDim.x / kCluster;
  const int per_row = c / VEC;                // packs of a row
  const int step = kThreads / sw;             // rows per step of the CTA
  const int width = sw * VEC;                 // columns of a full strip
  const int tid = threadIdx.x;
  const int rp = tid / sw;
  const int cv = blockIdx.y * sw + tid % sw;  // the thread's pack of a row
  // columns of this strip (the last may be partial)
  const int cols = min(sw, per_row - (int)blockIdx.y * sw) * VEC;
  float s[VEC], q[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) s[e] = q[e] = 0.f;
  if (rp < step && cv < per_row) {
    const Pack* xv = reinterpret_cast<const Pack*>(x);
    const int64_t r0 = ((int64_t)group * kCluster + rank) * rows;
    const int64_t r1 = r0 + rows < n ? r0 + rows : n;
    const int64_t next = (int64_t)step * per_row;   // packs one step down
    int64_t r = r0 + rp;
    int64_t i = r * per_row + cv;
    for (; r + (kRowsPerTurn - 1) * step < r1;
         r += kRowsPerTurn * step, i += kRowsPerTurn * next) {
      Pack xs[kRowsPerTurn];
#pragma unroll
      for (int k = 0; k < kRowsPerTurn; ++k) xs[k] = xv[i + k * next];
#pragma unroll
      for (int k = 0; k < kRowsPerTurn; ++k) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float v = to_float(xs[k].v[e]);
          s[e] += v;
          q[e] += v * v;
        }
      }
    }
    for (; r < r1; r += step, i += next) {
      const Pack xa = xv[i];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float v = to_float(xa.v[e]);
        s[e] += v;
        q[e] += v * v;
      }
    }
  }
  if (rp < step) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      red[0][rp * width + (tid % sw) * VEC + e] = s[e];
      red[1][rp * width + (tid % sw) * VEC + e] = q[e];
    }
  }
  __syncthreads();
  // the CTA's sums: its row phases added in order (unrolled, so that the
  // shared loads go out ahead of the adds)
  float a = 0.f, b = 0.f;
  if (tid < cols) {
#pragma unroll 8
    for (int p = 0; p < step; ++p) {
      a += red[0][p * width + tid];
      b += red[1][p * width + tid];
    }
  }
  cluster_wait();   // every CTA of the cluster runs
  if (tid < cols) {
    // into rank 0's shared memory, through distributed shared memory
    float* g0 = cluster.map_shared_rank(&gather[0][0][0], 0);
    g0[(2 * rank) * kMaxStripCols + tid] = a;
    g0[(2 * rank + 1) * kMaxStripCols + tid] = b;
  }
  cluster_arrive();   // release: this CTA's sums are in rank 0's memory
  cluster_wait();
  if (rank == 0 && tid < cols) {
    // the cluster's sums: the CTAs' sums in rank order
    a = b = 0.f;
#pragma unroll
    for (int k = 0; k < kCluster; ++k) {
      a += gather[k][0][tid];
      b += gather[k][1][tid];
    }
    const int col = blockIdx.y * width + tid;
    if (groups == 1) {
      mean[col] = a * inv_n;
      mean_sq[col] = b * inv_n;
    } else {
      part[(int64_t)group * c + col] = a;
      part[((int64_t)groups + group) * c + col] = b;
    }
  }
  if (groups > 1 && rank == 0)
    dcgan::finish_if_last(part, groups, c, inv_n, mean, mean_sq,
                          (unsigned)groups * gridDim.y, ticket);
}

// `strips` is the plan's; the launch refuses a plan whose strips differ
// from the ones this build's kStripVector / kStripScalar give
template <typename T, int VEC>
cudaError_t launch(const T* x, int64_t n, int c, int strips, int groups,
                   float inv_n, float* mean, float* mean_sq, float* part,
                   unsigned* ticket, cudaStream_t stream) {
  const int per_row = c / VEC;
  const int sw_max = VEC > 1 ? kStripVector : kStripScalar;
  const int sw = per_row < sw_max ? per_row : sw_max;
  if (strips != (per_row + sw - 1) / sw || strips > 65535 ||
      (int64_t)groups * kCluster > 0x7fffffff)
    return cudaErrorInvalidValue;
  const int64_t ctas = (int64_t)groups * kCluster;
  const int64_t rows = (n + ctas - 1) / ctas;
  auto kernel = moments_cluster_kernel<T, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas, (unsigned)strips, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, x, n, c, sw, rows, inv_n, mean,
                            mean_sq, part, ticket);
}

template <typename T>
cudaError_t launch_design(const void* x, int64_t n, int c, int design,
                          int strips, int groups, float inv_n, float* mean,
                          float* mean_sq, float* part, unsigned* ticket,
                          cudaStream_t stream) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const T* xt = static_cast<const T*>(x);
  if (design == kMomentsVector) {
    if (c % VEC != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
      return cudaErrorInvalidValue;
    return launch<T, VEC>(xt, n, c, strips, groups, inv_n, mean, mean_sq,
                          part, ticket, stream);
  }
  if (design == kMomentsScalar)
    return launch<T, 1>(xt, n, c, strips, groups, inv_n, mean, mean_sq, part,
                        ticket, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// C interface for ctypes. Returns a cudaError_t (0 = the launch was
// accepted). dtype of x: 0 = float32, 1 = bfloat16. mean and mean_sq are
// f32 [c]. design: 0 = scalar, 1 = vector; strips: column strips, groups:
// clusters per strip (ops/kernels.py::moments_plan); above one group, part
// is an f32 workspace [2][groups][c] (16-byte aligned) and ticket an int32
// counter of this kernel's own, 0 between launches. A design or plan the
// kernel cannot run is refused with cudaErrorInvalidValue.
extern "C" int dcgan_channel_moments(const void* x, float* mean,
                                     float* mean_sq, float* part,
                                     void* ticket, int design, int strips,
                                     int groups, int64_t n, int c, int dtype,
                                     float inv_n, void* stream) {
  if (n <= 0 || c <= 0) return (int)cudaSuccess;
  if (groups < 1 || (groups > 1 && (part == nullptr || ticket == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* t = static_cast<unsigned*>(ticket);
  switch (dtype) {
    case dcgan::kFloat32:
      return (int)launch_design<float>(x, n, c, design, strips, groups,
                                       inv_n, mean, mean_sq, part, t, s);
    case dcgan::kBFloat16:
      return (int)launch_design<__nv_bfloat16>(x, n, c, design, strips,
                                               groups, inv_n, mean, mean_sq,
                                               part, t, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

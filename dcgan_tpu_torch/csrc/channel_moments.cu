// channel_moments: mean[c] = sum_n x[n, c] / N, mean_sq[c] = sum_n x^2 / N
//
// Replaces the TPU kernel `_moments_kernel` (dcgan_tpu/ops/pallas_kernels.py,
// launched by `_moments_fwd_impl` through pl.pallas_call). It is the batch
// statistics of BatchNorm's train path under `use_pallas`: on the celeba64
// training step, G's `bn0` over the [16 B, 512] projection in the compute
// dtype; both outputs are f32 and the sums are multiplied by 1/N once at the
// end, as the TPU kernel's wrapper does.
//
// Bound: bytes, and in practice launch latency. One read of x: at B = 64
// (N = 1024, C = 512, bf16) 1 MB, 0.3 us at 3.35 TB/s; two FMAs per element
// are far below the card's compute.
//
// Design. The TPU kernel accumulates a [1, C] sum in place across a
// sequential row grid. GPU blocks run in no order, so the reduction is two
// passes (common.cuh): 32 x 8-thread blocks over a 32-column strip and a row
// chunk write f32 partial sums, then one thread per column adds the chunks
// in a fixed order and scales by 1/N. No atomics: two launches on the same
// input give the same bits. A warp reads 32 consecutive elements of a row.
// Still to do for speed: vector loads (two bf16 per thread), one launch.

#include <cstdint>

#include "common.cuh"

namespace {

using dcgan::kColTile;
using dcgan::kRowPhases;
using dcgan::to_float;

template <typename T>
__global__ void moments_partial(const T* __restrict__ x, int64_t n, int c,
                                int64_t rows, int chunks,
                                float* __restrict__ part) {
  const int col = blockIdx.x * kColTile + threadIdx.x;
  const int chunk = blockIdx.y;
  const int64_t r0 = (int64_t)chunk * rows;
  const int64_t r1 = r0 + rows < n ? r0 + rows : n;
  float s = 0.f, q = 0.f;
  if (col < c) {
    for (int64_t r = r0 + threadIdx.y; r < r1; r += kRowPhases) {
      const float v = to_float(x[r * c + col]);
      s += v;
      q += v * v;
    }
  }
  dcgan::write_column_partials(s, q, part, chunk, chunks, col, c);
}

template <typename T>
cudaError_t launch(const void* x, int64_t n, int c, float inv_n,
                   float* mean, float* mean_sq, float* part, int chunks,
                   cudaStream_t stream) {
  const dim3 grid((c + kColTile - 1) / kColTile, chunks);
  const dim3 block(kColTile, kRowPhases);
  moments_partial<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), n, c, dcgan::rows_per_chunk(n, chunks),
      chunks, part);
  dcgan::launch_finish(part, chunks, c, inv_n, mean, mean_sq, stream);
  return cudaGetLastError();
}

}  // namespace

// Row chunks of the partial-sum pass; the caller allocates the f32
// workspace part[2][chunks][c] with this.
extern "C" int dcgan_channel_moments_chunks(int64_t n, int c, int sm_count) {
  return dcgan::column_chunks(n, c, sm_count);
}

// C interface for ctypes. Returns a cudaError_t (0 = the launches were
// accepted). dtype of x: 0 = float32, 1 = bfloat16. mean and mean_sq are
// f32 [c]; part is the workspace sized by dcgan_channel_moments_chunks.
extern "C" int dcgan_channel_moments(const void* x, float* mean,
                                     float* mean_sq, float* part, int chunks,
                                     int64_t n, int c, int dtype, float inv_n,
                                     void* stream) {
  if (n <= 0 || c <= 0) return (int)cudaSuccess;
  if (chunks < 1 || chunks > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case dcgan::kFloat32:
      return (int)launch<float>(x, n, c, inv_n, mean, mean_sq, part, chunks,
                                s);
    case dcgan::kBFloat16:
      return (int)launch<__nv_bfloat16>(x, n, c, inv_n, mean, mean_sq, part,
                                        chunks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// gemm_bias_scale_act: y[m, c] = act((sum_k P[m, k] W[k, c] + b[c]) * scale[c]
//                                    + shift[c])
//
// Replaces the TPU kernel `_gemm_bias_scale_act_kernel`
// (dcgan_tpu/ops/pallas_fused.py, launched by `_gbsa_impl` through
// pl.pallas_call). It is a whole inference-mode interior generator stage:
// the im2col GEMM of the transposed conv, its bias, the BatchNorm affine
// folded from the running statistics, and the activation, in one pass.
// Accumulation is f32; b, scale and shift are f32 [C]; y is bf16 or f32.
//
// Shapes on the served path (celeba64, batch B, bf16, act = relu):
//   deconv1  M =   64 B  K = 12800  C = 256
//   deconv2  M =  256 B  K =  6400  C = 128
//   deconv3  M = 1024 B  K =  3200  C =  64
//
// Bound: bytes. At B = 64 each stage does 26.8 GFLOP, about 27 us of bf16
// tensor-core time at 989 TFLOP/s, but must read the patch matrix P once:
// 105, 210 and 419 MB, 31, 63 and 125 us at 3.35 TB/s.
//
// Design. The TPU kernel walks a sequential (row-block, k-block) grid and
// carries its f32 sum in a resident output block. Blocks on the GPU run in
// no order, so here each CTA owns one BM x BN output tile and loops over K
// itself, keeping the sum in registers; nothing crosses CTAs and nothing
// but y is written. The main loop is gemm_tiles.cuh's, shared with
// gemm_bias_moments.cu; this file holds the epilogue.
//   bf16 operands: a 128 x BN tile (BN = 128, or 64 when C <= 64 so the
//   last stage wastes no MMA work), 8 warps issuing WMMA 16x16x16 bf16
//   products with f32 accumulators, K walked in steps of 32 through a
//   two-stage cp.async ring in shared memory (45 KB at BN = 128, 37 KB at
//   BN = 64), so the next P/W tiles stream in while the current ones
//   multiply. Column tiles of one row block are adjacent CTAs, so the
//   second read of a P tile (C = 256) hits L2.
//   f32 operands: a 64 x 64 SIMT tile with 4 x 4 outputs per thread, full
//   f32 FMAs (the tensor cores' TF32 would drop mantissa bits).
//   Split-K where the output tiles alone cannot fill the card (the first
//   stage has 64 tiles at B = 64): CTA groups sum disjoint K ranges into an
//   f32 workspace and a second elementwise kernel adds them in a fixed
//   order and applies the epilogue, so results stay deterministic.
//   __launch_bounds__(256, 2) keeps two CTAs resident per SM.
//   Ragged M, K and C are masked: out-of-range loads fill zeros and
//   out-of-range stores are skipped. cp.async needs 16-byte chunks, so it
//   is used only when K and C are multiples of 8 and P, W are 16-byte
//   aligned; otherwise the tiles are loaded element by element.
//   The epilogue stages each 16 x 16 accumulator through a per-warp
//   shared-memory scratch and applies bias, scale, shift and act in f32
//   before one rounding to y's dtype.
// Still to do for speed: wgmma + TMA, and an implicit GEMM that never
// materializes P (whose zero-dilated rows carry ~4x the useful products).

#include <cstdint>

#include "gemm_tiles.cuh"

namespace {

using namespace nvcuda;
using namespace dcgan::gemm;
using dcgan::apply_act;
using dcgan::from_float;

// ws == nullptr: one pass over all of K, epilogue applied here.
// ws != nullptr: split-K; CTA group `split` sums K range
// [split * k_chunk, (split + 1) * k_chunk) into the f32 workspace
// ws[split][M][C], and gbsa_splitk_epilogue finishes.
template <int BN, typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
    gbsa_wmma_kernel(const bf16* __restrict__ P, const bf16* __restrict__ W,
                     const float* __restrict__ bias,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift, OutT* __restrict__ Y,
                     float* __restrict__ ws, int M, int K, int C,
                     int n_row_tiles, int n_col_tiles, int k_chunk,
                     bool aligned, int act, float leak) {
  using T = Tile<BN>;
  static_assert(T::SMEM_BYTES <= 48 * 1024, "static shared memory limit");
  __shared__ __align__(128) unsigned char smem[T::SMEM_BYTES];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + STAGES * T::A_STAGE;
  float* scratch = reinterpret_cast<float*>(Bs + STAGES * T::B_STAGE);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // column tiles of one row block are adjacent CTAs (they share P rows);
  // the split index varies slowest
  const int tiles = n_row_tiles * n_col_tiles;
  const int split = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int m0 = (tile / n_col_tiles) * BM;
  const int n0 = (tile % n_col_tiles) * BN;
  const int k_begin = split * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int wm = warp / T::WARPS_N;
  const int wn = warp % T::WARPS_N;

  Frag acc[T::FM][T::FN];
  wmma_tile_product<BN>(P, W, M, K, C, m0, n0, k_begin, k_end, aligned, As,
                        Bs, acc);

  // epilogue: each lane finishes 8 consecutive columns of one row
  float* sc = scratch + warp * 256;
  const int r = lane >> 1;
  const int c8 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < T::FM; ++i) {
#pragma unroll
    for (int j = 0; j < T::FN; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = m0 + wm * T::WM + i * 16 + r;
      const int col0 = n0 + wn * 32 + j * 16 + c8;
      if (row < M) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int col = col0 + e;
          if (col >= C) continue;
          if (ws != nullptr) {
            ws[((int64_t)split * M + row) * C + col] = sc[r * 16 + c8 + e];
          } else {
            const float u = sc[r * 16 + c8 + e] + bias[col];
            const float v = u * scale[col] + shift[col];
            Y[(int64_t)row * C + col] = from_float<OutT>(apply_act(v, act, leak));
          }
        }
      }
      __syncwarp();
    }
  }
}

// split-K finish: y = act((sum_s ws[s] + b) * scale + shift), the partial
// sums added in split order (deterministic)
template <typename OutT>
__global__ void gbsa_splitk_epilogue(const float* __restrict__ ws,
                                     int splits,
                                     const float* __restrict__ bias,
                                     const float* __restrict__ scale,
                                     const float* __restrict__ shift,
                                     OutT* __restrict__ Y, int64_t mc, int C,
                                     int act, float leak) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < mc;
       i += stride) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += ws[s * mc + i];
    const int col = (int)(i % C);
    const float u = acc + bias[col];
    const float v = u * scale[col] + shift[col];
    Y[i] = from_float<OutT>(apply_act(v, act, leak));
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
    gbsa_simt_kernel(const float* __restrict__ P, const float* __restrict__ W,
                     const float* __restrict__ bias,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift, OutT* __restrict__ Y,
                     int M, int K, int C, int n_col_tiles, int act,
                     float leak) {
  __shared__ SimtSmem sm;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = (blockIdx.x / n_col_tiles) * SBM;
  const int n0 = (blockIdx.x % n_col_tiles) * SBN;
  float acc[4][4];
  simt_tile_product(P, W, M, K, C, m0, n0, sm, acc);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < C) {
        const float u = acc[i][j] + bias[col];
        const float v = u * scale[col] + shift[col];
        Y[(int64_t)row * C + col] = from_float<OutT>(apply_act(v, act, leak));
      }
    }
  }
}

template <int BN, typename OutT>
void launch_wmma(const void* p, const void* w, const float* bias,
                 const float* scale, const float* shift, void* y, float* ws,
                 int splits, int m, int k, int c, int act, float leak,
                 cudaStream_t stream) {
  const int n_col = (c + BN - 1) / BN;
  const int n_row = (m + BM - 1) / BM;
  const bool aligned = (k % 8 == 0) && (c % 8 == 0) &&
                       ((reinterpret_cast<uintptr_t>(p) |
                         reinterpret_cast<uintptr_t>(w)) % 16 == 0);
  const int chunk = splits > 1 ? k_chunk(k, splits) : k;
  gbsa_wmma_kernel<BN, OutT>
      <<<n_col * n_row * splits, kThreads, 0, stream>>>(
          static_cast<const bf16*>(p), static_cast<const bf16*>(w), bias,
          scale, shift, static_cast<OutT*>(y), splits > 1 ? ws : nullptr, m,
          k, c, n_row, n_col, chunk, aligned, act, leak);
  if (splits > 1) {
    const int64_t mc = (int64_t)m * c;
    int64_t blocks = (mc + kThreads - 1) / kThreads;
    if (blocks > 132 * 16) blocks = 132 * 16;
    gbsa_splitk_epilogue<OutT><<<(unsigned)blocks, kThreads, 0, stream>>>(
        ws, splits, bias, scale, shift, static_cast<OutT*>(y), mc, c, act,
        leak);
  }
}

template <typename OutT>
cudaError_t launch(const void* p, const void* w, const float* bias,
                   const float* scale, const float* shift, void* y,
                   float* ws, int splits, int m, int k, int c, int in_dtype,
                   int act, float leak, cudaStream_t stream) {
  if (in_dtype == dcgan::kBFloat16) {
    if (splits < 1 || (splits > 1 && ws == nullptr))
      return cudaErrorInvalidValue;
    if (tile_n(c) == 64)
      launch_wmma<64, OutT>(p, w, bias, scale, shift, y, ws, splits, m, k, c,
                            act, leak, stream);
    else
      launch_wmma<128, OutT>(p, w, bias, scale, shift, y, ws, splits, m, k,
                             c, act, leak, stream);
  } else if (in_dtype == dcgan::kFloat32) {
    if (splits != 1) return cudaErrorInvalidValue;
    const int n_col = (c + 63) / 64;
    const int n_row = (m + 63) / 64;
    gbsa_simt_kernel<OutT><<<n_col * n_row, kThreads, 0, stream>>>(
        static_cast<const float*>(p), static_cast<const float*>(w), bias,
        scale, shift, static_cast<OutT*>(y), m, k, c, n_col, act, leak);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// How many K splits the launch below should use for this shape: enough
// that the output tiles times the splits fill the card (two CTAs per SM
// are resident), keeping at least 256 of K per split. Output tiles alone
// fill it at the last served stage; the first (M = 64 B, C = 256,
// K = 12800) has 64 tiles at B = 64 and takes 4 splits. The caller
// allocates the f32 workspace [splits, m, c] when this is above 1.
extern "C" int dcgan_gemm_bias_scale_act_splits(int m, int k, int c,
                                                int in_dtype, int sm_count) {
  return choose_splits(m, k, c, in_dtype, sm_count);
}

// C interface for ctypes. Returns a cudaError_t (0 = the launch was
// accepted). in_dtype is the dtype of P and W, out_dtype that of y:
// 0 = float32, 1 = bfloat16. bias, scale and shift are f32 [c]. With
// splits > 1 (bf16 operands only), ws is an f32 workspace of
// splits * m * c elements and a second, elementwise kernel finishes.
extern "C" int dcgan_gemm_bias_scale_act(const void* p, const void* w,
                                         const float* bias,
                                         const float* scale,
                                         const float* shift, void* y,
                                         float* ws, int splits, int m, int k,
                                         int c, int in_dtype, int out_dtype,
                                         int act, float leak, void* stream) {
  if (m <= 0 || c <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case dcgan::kFloat32:
      return (int)launch<float>(p, w, bias, scale, shift, y, ws, splits, m,
                                k, c, in_dtype, act, leak, s);
    case dcgan::kBFloat16:
      return (int)launch<bf16>(p, w, bias, scale, shift, y, ws, splits, m,
                               k, c, in_dtype, act, leak, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

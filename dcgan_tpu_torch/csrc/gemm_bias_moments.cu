// gemm_bias_moments: u[m, c] = sum_k P[m, k] W[k, c] + b[c]   (f32 out)
//                    mean[c] = sum_m v / M,  mean_sq[c] = sum_m v^2 / M
// with v = u rounded to bf16 and widened back when the compute dtype is
// bf16 (the value the model goes on to see), else v = u.
//
// Replaces the TPU kernel `_gemm_bias_moments_kernel`
// (dcgan_tpu/ops/pallas_fused.py, launched by `_gbm_impl` through
// pl.pallas_call). It is the train-mode forward of every interior G and D
// stage under `pallas_fused`: the im2col GEMM of the (transposed) conv, its
// bias, and BatchNorm's batch statistics of the result, in one pass; the
// BN epilogue follows in scale_shift_act.cu.
//
// Shapes on the celeba64 training step (batch B, bf16 operands):
//   G deconv1  M =   64 B  K = 12800  C = 256
//   G deconv2  M =  256 B  K =  6400  C = 128
//   G deconv3  M = 1024 B  K =  3200  C =  64
//   D conv1    M =  256 B  K =  1600  C = 128
//   D conv2    M =   64 B  K =  3200  C = 256
//   D conv3    M =   16 B  K =  6400  C = 512
//
// Bound: bytes. At B = 64 it must read P and W once and write u in f32:
// G 115.6 / 219.7 / 436.6 MB (34.5 / 65.6 / 130 us at 3.35 TB/s) against
// 26.8 GFLOP (27 us of bf16 tensor time) each; D 61.2 / 32.0 / 21.8 MB
// (18.3 / 9.6 / 6.5 us) against 6.7 GFLOP (6.8 us) each.
//
// Design. One CTA per output tile loops over K with the sum in registers,
// in one of kernel 5's three designs; the launch plan is kernel 5's own
// (ops/fused.py::gbsa_plan), and the launch below refuses a plan it cannot
// run:
//   v2, bf16 operands with K and C multiples of 8 and 16-byte-aligned P and
//   W (TMA's rule), every celeba64 stage: gemm_wgmma.cuh's main loop (TMA
//   into 128-byte-swizzled stages, one producer warp, two consumer
//   warpgroups issuing wgmma, N tile all of C up to 256). The moments
//   epilogue works on the accumulator registers, n8 tile by n8 tile: add
//   the bias and store u as float2 pairs, round v, sum v and v^2 over the
//   thread's two rows, reduce over the 8 lanes sharing a column pair
//   (shuffles 4, 8, 16), and write each warp's 16-row sums into a shared
//   [8 warps][BN] scratch laid over the ring (free once every consumer
//   warpgroup has waited on its last wgmma group; the barriers are named
//   and count the 256 consumer threads, since the producer warp has
//   returned). The consumers then add the 8 warp rows in warp order into
//   part[2][row tile][C];
//   v1, other bf16 operands: gemm_tiles.cuh's WMMA loop, each 16 x 16
//   fragment through the warp's shared scratch, 16 lanes adding one column
//   each in row order, then the warps' partials in warp order;
//   SIMT for f32 operands (full f32 FMAs).
//   Split-K where the output tiles alone cannot fill the card (D conv2, D
//   conv3, G deconv1 at B = 64): the CTAs write raw partial products to an
//   f32 workspace, and a finish pass over 32-column strips and row chunks
//   adds the splits in split order, adds the bias, writes u and emits the
//   chunk's partial moments.
// Then one thread per column adds the partials in a fixed order and scales
// by 1/M. The TPU kernel accumulated the moments in place across its
// sequential grid; no atomics here, so two launches give the same bits.
// Still to do for speed: an implicit GEMM that never materializes P.

#include <cstdint>

#include "gemm_tiles.cuh"
#include "gemm_wgmma.cuh"

namespace {

using namespace nvcuda;
using namespace dcgan::gemm;
using dcgan::kColTile;
using dcgan::kRowPhases;

__device__ __forceinline__ float moment_value(float u, bool round_bf16) {
  return round_bf16 ? __bfloat162float(__float2bfloat16_rn(u)) : u;
}

// Design v1 (see the top of the file).
// ws == nullptr: one pass over all of K, u and the tile's partial moments
// written here (part[2][n_row_tiles][C]).
// ws != nullptr: split-K; CTA group `split` sums K range
// [split * k_chunk, (split + 1) * k_chunk) into ws[split][M][C], and
// gbm_splitk_finish finishes.
template <int BN>
__global__ void __launch_bounds__(kThreads, 2)
    gbm_wmma_kernel(const bf16* __restrict__ P, const bf16* __restrict__ W,
                    const float* __restrict__ bias, float* __restrict__ U,
                    float* __restrict__ ws, float* __restrict__ part, int M,
                    int K, int C, int n_row_tiles, int n_col_tiles,
                    int k_chunk, bool aligned, bool round_bf16) {
  using T = Tile<BN>;
  static_assert(T::SMEM_BYTES + 2 * T::WARPS_M * BN * (int)sizeof(float) <=
                    48 * 1024,
                "static shared memory limit");
  __shared__ __align__(128) unsigned char smem[T::SMEM_BYTES];
  __shared__ float colsum[2][T::WARPS_M][BN];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + STAGES * T::A_STAGE;
  float* scratch = reinterpret_cast<float*>(Bs + STAGES * T::B_STAGE);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int tiles = n_row_tiles * n_col_tiles;
  const int split = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int row_tile = tile / n_col_tiles;
  const int m0 = row_tile * BM;
  const int n0 = (tile % n_col_tiles) * BN;
  const int k_begin = split * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int wm = warp / T::WARPS_N;
  const int wn = warp % T::WARPS_N;

  Frag acc[T::FM][T::FN];
  wmma_tile_product<BN>(P, W, M, K, C, m0, n0, k_begin, k_end, aligned, As,
                        Bs, acc);

  // epilogue: each lane writes 8 consecutive columns of one row; lanes
  // 0..15 also add column `lane` of the fragment over its 16 rows
  float* sc = scratch + warp * 256;
  const int r = lane >> 1;
  const int c8 = (lane & 1) * 8;
  float s_acc[T::FN], q_acc[T::FN];
#pragma unroll
  for (int j = 0; j < T::FN; ++j) s_acc[j] = q_acc[j] = 0.f;
#pragma unroll
  for (int i = 0; i < T::FM; ++i) {
#pragma unroll
    for (int j = 0; j < T::FN; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int frag_row = m0 + wm * T::WM + i * 16;
      const int row = frag_row + r;
      const int col0 = n0 + wn * 32 + j * 16 + c8;
      if (row < M) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int col = col0 + e;
          if (col >= C) continue;
          if (ws != nullptr)
            ws[((int64_t)split * M + row) * C + col] = sc[r * 16 + c8 + e];
          else
            U[(int64_t)row * C + col] = sc[r * 16 + c8 + e] + bias[col];
        }
      }
      const int col = n0 + wn * 32 + j * 16 + lane;
      if (ws == nullptr && lane < 16 && col < C) {
        const float b = bias[col];
        for (int rr = 0; rr < 16 && frag_row + rr < M; ++rr) {
          const float v = moment_value(sc[rr * 16 + lane] + b, round_bf16);
          s_acc[j] += v;
          q_acc[j] += v * v;
        }
      }
      __syncwarp();
    }
  }
  if (ws != nullptr) return;  // uniform across the CTA
  if (lane < 16) {
#pragma unroll
    for (int j = 0; j < T::FN; ++j) {
      colsum[0][wm][wn * 32 + j * 16 + lane] = s_acc[j];
      colsum[1][wm][wn * 32 + j * 16 + lane] = q_acc[j];
    }
  }
  __syncthreads();
  for (int cc = tid; cc < BN; cc += kThreads) {
    const int col = n0 + cc;
    if (col >= C) continue;
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int w = 0; w < T::WARPS_M; ++w) {
      s += colsum[0][w][cc];
      q += colsum[1][w][cc];
    }
    part[(int64_t)row_tile * C + col] = s;
    part[((int64_t)n_row_tiles + row_tile) * C + col] = q;
  }
}

namespace wg = dcgan::wgmma_gemm;

__device__ __forceinline__ void store2(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}

// A barrier over the consumer warpgroups only (named barrier 1; 0 is
// __syncthreads'): the producer warp has returned by the epilogue
template <int THREADS>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(THREADS) : "memory");
}

// Design v2 (see the top of the file). CTA blockIdx.x: split-K group
// blockIdx.x / tiles over K blocks [split * kb_per_split, + kb_per_split),
// output tile blockIdx.x % tiles, column tiles of one row block adjacent.
// ws == nullptr: u and the tile's partial moments written here
// (part[2][n_row_tiles][C]); else the f32 partial products go to
// ws[split][M][C] for gbm_splitk_finish. C is a multiple of 8.
template <int BN>
__global__ void __launch_bounds__(wg::WgmmaTile<BN>::kThreads,
                                  wg::WgmmaTile<BN>::kMinBlocks)
    gbm_wgmma_kernel(const __grid_constant__ CUtensorMap map_p,
                     const __grid_constant__ CUtensorMap map_w,
                     const float* __restrict__ bias, float* __restrict__ U,
                     float* __restrict__ ws, float* __restrict__ part, int M,
                     int C, int n_row_tiles, int n_col_tiles, int n_kb,
                     int kb_per_split, bool round_bf16) {
  using T = wg::WgmmaTile<BN>;
  constexpr int kWarps = 4 * T::kConsumers;
  static_assert(2 * kWarps * BN * (int)sizeof(float)
                    <= T::kStages * T::kStageBytes,
                "the moments scratch fits in the ring");
  extern __shared__ unsigned char smem[];
  const int tiles = n_row_tiles * n_col_tiles;
  const int split = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int row_tile = tile / n_col_tiles;
  const int m0 = row_tile * wg::kBM;
  const int n0 = (tile % n_col_tiles) * BN;
  const int kb_begin = split * kb_per_split;
  const int kb_end = min(n_kb, kb_begin + kb_per_split);
  float acc[BN / 2];
  if (!wg::wgmma_tile_product<BN>(map_p, map_w, smem, m0, n0, kb_begin,
                                  kb_end, acc))
    return;

  // the fragment layout: warp w holds rows 16 w + lane / 4 and 8 below,
  // columns 8 j + 2 (lane % 4) + {0, 1} of n8 tile j
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = m0 + 16 * warp + lane / 4;
  const int col0 = n0 + 2 * (lane % 4);
  const bool in0 = row0 < M, in1 = row0 + 8 < M;
  if (ws != nullptr) {   // uniform across the CTA
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if (n0 + 8 * j >= C) continue;   // C % 8 == 0: uniform over the warp
      const int col = col0 + 8 * j;
      float* w0 = ws + ((int64_t)split * M + row0) * C + col;
      if (in0) store2(w0, acc[4 * j], acc[4 * j + 1]);
      if (in1) store2(w0 + 8 * (int64_t)C, acc[4 * j + 2], acc[4 * j + 3]);
    }
    return;
  }

  // the [2][kWarps][BN] scratch overlays the ring, whose last reads (the
  // other warpgroup's wgmma) are done after this barrier
  consumer_sync<T::kConsumers * 128>();
  float* sum_v = reinterpret_cast<float*>(smem);
  float* sum_q = sum_v + kWarps * BN;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    if (n0 + 8 * j >= C) continue;
    const int col = col0 + 8 * j;
    const float b0 = bias[col], b1 = bias[col + 1];
    const float u00 = acc[4 * j] + b0, u01 = acc[4 * j + 1] + b1;
    const float u10 = acc[4 * j + 2] + b0, u11 = acc[4 * j + 3] + b1;
    float* p0 = U + (int64_t)row0 * C + col;
    if (in0) store2(p0, u00, u01);
    if (in1) store2(p0 + 8 * (int64_t)C, u10, u11);
    // rows past M hold zeros from the TMA but not u = b: masked
    const float v00 = in0 ? moment_value(u00, round_bf16) : 0.f;
    const float v01 = in0 ? moment_value(u01, round_bf16) : 0.f;
    const float v10 = in1 ? moment_value(u10, round_bf16) : 0.f;
    const float v11 = in1 ? moment_value(u11, round_bf16) : 0.f;
    float s0 = v00 + v10, s1 = v01 + v11;
    float q0 = v00 * v00 + v10 * v10, q1 = v01 * v01 + v11 * v11;
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      q0 += __shfl_xor_sync(0xffffffffu, q0, o);
      q1 += __shfl_xor_sync(0xffffffffu, q1, o);
    }
    if (lane < 4) {
      const int cc = warp * BN + 8 * j + 2 * lane;
      sum_v[cc] = s0;
      sum_v[cc + 1] = s1;
      sum_q[cc] = q0;
      sum_q[cc + 1] = q1;
    }
  }
  consumer_sync<T::kConsumers * 128>();
  for (int cc = threadIdx.x; cc < BN; cc += T::kConsumers * 128) {
    const int col = n0 + cc;
    if (col >= C) break;
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      s += sum_v[w * BN + cc];
      q += sum_q[w * BN + cc];
    }
    part[(int64_t)row_tile * C + col] = s;
    part[((int64_t)n_row_tiles + row_tile) * C + col] = q;
  }
}

// split-K finish over a 32-column strip and a row chunk: u = (sum of the
// splits in split order) + b, written, and the chunk's partial moments
__global__ void gbm_splitk_finish(const float* __restrict__ ws, int splits,
                                  const float* __restrict__ bias,
                                  float* __restrict__ U, int M, int C,
                                  int64_t rows, int chunks, bool round_bf16,
                                  float* __restrict__ part) {
  const int col = blockIdx.x * kColTile + threadIdx.x;
  const int chunk = blockIdx.y;
  const int64_t r0 = (int64_t)chunk * rows;
  const int64_t r1 = r0 + rows < M ? r0 + rows : (int64_t)M;
  const int64_t mc = (int64_t)M * C;
  float s = 0.f, q = 0.f;
  if (col < C) {
    const float b = bias[col];
    for (int64_t r = r0 + threadIdx.y; r < r1; r += kRowPhases) {
      const int64_t i = r * C + col;
      float acc = 0.f;
      for (int sp = 0; sp < splits; ++sp) acc += ws[sp * mc + i];
      const float u = acc + b;
      U[i] = u;
      const float v = moment_value(u, round_bf16);
      s += v;
      q += v * v;
    }
  }
  dcgan::write_column_partials(s, q, part, chunk, chunks, col, C);
}

__global__ void __launch_bounds__(kThreads)
    gbm_simt_kernel(const float* __restrict__ P, const float* __restrict__ W,
                    const float* __restrict__ bias, float* __restrict__ U,
                    float* __restrict__ part, int M, int K, int C,
                    int n_row_tiles, int n_col_tiles, bool round_bf16) {
  __shared__ SimtSmem sm;
  __shared__ float colsum[2][16][SBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row_tile = blockIdx.x / n_col_tiles;
  const int m0 = row_tile * SBM;
  const int n0 = (blockIdx.x % n_col_tiles) * SBN;
  float acc[4][4];
  simt_tile_product(P, W, M, K, C, m0, n0, sm, acc);

  float s[4] = {0.f, 0.f, 0.f, 0.f}, q[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < C) {
        const float u = acc[i][j] + bias[col];
        U[(int64_t)row * C + col] = u;
        const float v = moment_value(u, round_bf16);
        s[j] += v;
        q[j] += v * v;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    colsum[0][ty][tx * 4 + j] = s[j];
    colsum[1][ty][tx * 4 + j] = q[j];
  }
  __syncthreads();
  for (int cc = tid; cc < SBN; cc += kThreads) {
    const int col = n0 + cc;
    if (col >= C) continue;
    float ss = 0.f, qq = 0.f;
    for (int t = 0; t < 16; ++t) {
      ss += colsum[0][t][cc];
      qq += colsum[1][t][cc];
    }
    part[(int64_t)row_tile * C + col] = ss;
    part[((int64_t)n_row_tiles + row_tile) * C + col] = qq;
  }
}

// partials of the moments: row tiles without split-K, row chunks of the
// finish pass with it
int parts_for(int m, int c, int in_dtype, int splits, int sm_count) {
  if (in_dtype == dcgan::kFloat32) return (m + SBM - 1) / SBM;
  if (splits > 1) return dcgan::column_chunks(m, c, sm_count);
  return (m + BM - 1) / BM;
}

void launch_splitk_finish(const float* ws, int splits, const float* bias,
                          float* u, float* part, int parts, int m, int c,
                          bool round_bf16, cudaStream_t stream) {
  const dim3 grid((c + kColTile - 1) / kColTile, parts);
  const dim3 block(kColTile, kRowPhases);
  gbm_splitk_finish<<<grid, block, 0, stream>>>(
      ws, splits, bias, u, m, c, dcgan::rows_per_chunk(m, parts), parts,
      round_bf16, part);
}

template <int BN>
void launch_wmma(const void* p, const void* w, const float* bias, float* u,
                 float* ws, float* part, int parts, int splits, int m, int k,
                 int c, bool aligned, bool round_bf16, cudaStream_t stream) {
  const int n_col = (c + BN - 1) / BN;
  const int n_row = (m + BM - 1) / BM;
  const int chunk = splits > 1 ? k_chunk(k, splits) : k;
  gbm_wmma_kernel<BN><<<n_col * n_row * splits, kThreads, 0, stream>>>(
      static_cast<const bf16*>(p), static_cast<const bf16*>(w), bias, u,
      splits > 1 ? ws : nullptr, part, m, k, c, n_row, n_col, chunk, aligned,
      round_bf16);
  if (splits > 1)
    launch_splitk_finish(ws, splits, bias, u, part, parts, m, c, round_bf16,
                         stream);
}

template <int BN>
cudaError_t launch_wgmma(const void* p, const void* w, const float* bias,
                         float* u, float* ws, float* part, int parts,
                         int stages, int splits, int m, int k, int c,
                         bool round_bf16, cudaStream_t stream) {
  using T = wg::WgmmaTile<BN>;
  if (stages != T::kStages) return cudaErrorInvalidValue;
  CUtensorMap map_p, map_w;
  if (!wg::bf16_tensor_map(&map_p, p, m, k, wg::kBM, wg::kBK) ||
      !wg::bf16_tensor_map(&map_w, w, k, c, wg::kBK, 64))
    return cudaErrorInvalidValue;
  auto kernel = gbm_wgmma_kernel<BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int n_col = (c + BN - 1) / BN;
  const int n_row = (m + wg::kBM - 1) / wg::kBM;
  const int n_kb = (k + wg::kBK - 1) / wg::kBK;
  const int per_split = (n_kb + splits - 1) / splits;
  kernel<<<n_col * n_row * splits, T::kThreads, T::kSmemBytes, stream>>>(
      map_p, map_w, bias, u, splits > 1 ? ws : nullptr, part, m, c, n_row,
      n_col, n_kb, per_split, round_bf16);
  if (splits > 1)
    launch_splitk_finish(ws, splits, bias, u, part, parts, m, c, round_bf16,
                         stream);
  return cudaSuccess;
}

// Runs the plan (design, bm, bn, stages, splits) or refuses it with
// cudaErrorInvalidValue where it does not fit the operands or this build's
// tile constants.
cudaError_t launch(const void* p, const void* w, const float* bias, float* u,
                   float* ws, float* part, int design, int bm, int bn,
                   int stages, int splits, int parts, int m, int k, int c,
                   int in_dtype, bool round_bf16, cudaStream_t stream) {
  const bool aligned = k % 8 == 0 && c % 8 == 0 && aligned16(p) &&
                       aligned16(w);
  if (splits < 1 || (splits > 1 && ws == nullptr) || bm < 1)
    return cudaErrorInvalidValue;
  if (splits == 1 ? parts != (m + bm - 1) / bm
                  : (parts < 1 || parts > 65535))
    return cudaErrorInvalidValue;
  if (design == kWgmma) {
    if (in_dtype != dcgan::kBFloat16 || !aligned || bm != wg::kBM ||
        bn != wg::tile_n(c))
      return cudaErrorInvalidValue;
    if (bn == 64)
      return launch_wgmma<64>(p, w, bias, u, ws, part, parts, stages, splits,
                              m, k, c, round_bf16, stream);
    if (bn == 128)
      return launch_wgmma<128>(p, w, bias, u, ws, part, parts, stages,
                               splits, m, k, c, round_bf16, stream);
    return launch_wgmma<256>(p, w, bias, u, ws, part, parts, stages, splits,
                             m, k, c, round_bf16, stream);
  }
  if (design == kWmma) {
    if (in_dtype != dcgan::kBFloat16 || bm != BM || bn != tile_n(c) ||
        stages != STAGES)
      return cudaErrorInvalidValue;
    if (bn == 64)
      launch_wmma<64>(p, w, bias, u, ws, part, parts, splits, m, k, c,
                      aligned, round_bf16, stream);
    else
      launch_wmma<128>(p, w, bias, u, ws, part, parts, splits, m, k, c,
                       aligned, round_bf16, stream);
    return cudaSuccess;
  }
  if (design == kSimt) {
    if (in_dtype != dcgan::kFloat32 || splits != 1 || bm != SBM ||
        bn != SBN || stages != 1)
      return cudaErrorInvalidValue;
    const int n_col = (c + SBN - 1) / SBN;
    gbm_simt_kernel<<<n_col * parts, kThreads, 0, stream>>>(
        static_cast<const float*>(p), static_cast<const float*>(w), bias, u,
        part, m, k, c, parts, n_col, round_bf16);
    return cudaSuccess;
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// How many partial moments per column the launch writes; the caller
// allocates the f32 workspace part[2][parts][c].
extern "C" int dcgan_gemm_bias_moments_parts(int m, int c, int in_dtype,
                                             int splits, int sm_count) {
  return parts_for(m, c, in_dtype, splits, sm_count);
}

// C interface for ctypes. Returns a cudaError_t (0 = the launches were
// accepted). in_dtype is the dtype of P and W (0 = float32, 1 = bfloat16);
// bias, u, mean and mean_sq are f32. design, bm, bn, stages and splits are
// the launch plan of ops/fused.py::gbsa_plan (design 0 = f32 SIMT, 1 = v1
// WMMA, 2 = v2 wgmma). round_bf16: take the moments of bf16(u). ws: the
// split-K workspace of splits * m * c floats (splits > 1, bf16 only);
// part: the partial-moment workspace of `parts` rows.
extern "C" int dcgan_gemm_bias_moments(const void* p, const void* w,
                                       const float* bias, float* u,
                                       float* mean, float* mean_sq, float* ws,
                                       float* part, int design, int bm,
                                       int bn, int stages, int splits,
                                       int parts, int m, int k, int c,
                                       int in_dtype, int round_bf16,
                                       float inv_m, void* stream) {
  if (m <= 0 || c <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      launch(p, w, bias, u, ws, part, design, bm, bn, stages, splits, parts,
             m, k, c, in_dtype, round_bf16 != 0, s);
  if (err != cudaSuccess) return (int)err;
  dcgan::launch_finish(part, parts, c, inv_m, mean, mean_sq, s);
  return (int)cudaGetLastError();
}

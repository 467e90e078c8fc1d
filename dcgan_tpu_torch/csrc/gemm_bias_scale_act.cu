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
// but y is written.
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

#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using dcgan::apply_act;
using dcgan::from_float;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps
constexpr int BM = 128;
constexpr int BK = 32;
// cp.async ring depth: one tile in flight while one multiplies. A
// four-stage ring (82 KB of dynamic shared memory) measured the same on
// the H100: the loop is bound by WMMA issue, not by load latency.
constexpr int STAGES = 2;
// row pitch of the A tile: 80 bytes keeps every row 16-byte aligned for
// cp.async and is a multiple of 8 elements, as WMMA's ldm must be
constexpr int A_LD = BK + 8;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;  // 0 source bytes: fill with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int BN>
struct Tile {
  static constexpr int B_LD = BN + 8;            // 16-byte-aligned rows
  static constexpr int WARPS_N = BN / 32;        // each warp: 32 columns
  static constexpr int WARPS_M = 8 / WARPS_N;
  static constexpr int WM = BM / WARPS_M;        // rows per warp
  static constexpr int FM = WM / 16;             // 16x16 fragments per warp
  static constexpr int FN = 2;
  static constexpr int A_STAGE = BM * A_LD;      // elements per ring stage
  static constexpr int B_STAGE = BK * B_LD;
  static constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) *
                                        (int)sizeof(bf16) +
                                    8 * 256 * (int)sizeof(float);
};

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

  auto load_tile = [&](int stage, int k0) {
    bf16* a = As + stage * T::A_STAGE;
    bf16* b = Bs + stage * T::B_STAGE;
    if (aligned) {
      for (int ch = tid; ch < BM * BK / 8; ch += kThreads) {
        const int r = ch / (BK / 8), c8 = (ch % (BK / 8)) * 8;
        const int gr = m0 + r, gk = k0 + c8;
        const bool ok = gr < M && gk < k_end;
        cp_async16(a + r * A_LD + c8, ok ? P + (int64_t)gr * K + gk : P, ok);
      }
      for (int ch = tid; ch < BK * BN / 8; ch += kThreads) {
        const int r = ch / (BN / 8), c8 = (ch % (BN / 8)) * 8;
        const int gk = k0 + r, gc = n0 + c8;
        const bool ok = gk < k_end && gc < C;
        cp_async16(b + r * T::B_LD + c8, ok ? W + (int64_t)gk * C + gc : W,
                   ok);
      }
    } else {
      const bf16 zero = __float2bfloat16_rn(0.f);
      for (int e = tid; e < BM * BK; e += kThreads) {
        const int r = e / BK, kk = e % BK;
        const int gr = m0 + r, gk = k0 + kk;
        a[r * A_LD + kk] =
            (gr < M && gk < k_end) ? P[(int64_t)gr * K + gk] : zero;
      }
      for (int e = tid; e < BK * BN; e += kThreads) {
        const int r = e / BN, cc = e % BN;
        const int gk = k0 + r, gc = n0 + cc;
        b[r * T::B_LD + cc] =
            (gk < k_end && gc < C) ? W[(int64_t)gk * C + gc] : zero;
      }
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::FM][T::FN];
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int KT = (k_end - k_begin + BK - 1) / BK;
  // prologue: tiles 0 .. STAGES-2 in flight, one commit group each
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < KT) load_tile(st, k_begin + st * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    // STAGES-1+kt groups committed; tile kt's is done once at most
    // STAGES-2 are pending (groups complete in order)
    cp_async_wait<STAGES - 2>();
    // one barrier: tile kt is visible to every warp, and every warp has
    // finished computing on tile kt-1, whose stage is refilled next
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < KT) load_tile(next % STAGES, k_begin + next * BK);
    cp_async_commit();
    const bf16* a = As + (kt % STAGES) * T::A_STAGE;
    const bf16* b = Bs + (kt % STAGES) * T::B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          fa[T::FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          fb[T::FN];
#pragma unroll
      for (int i = 0; i < T::FM; ++i)
        wmma::load_matrix_sync(fa[i], a + (wm * T::WM + i * 16) * A_LD + kk,
                               A_LD);
#pragma unroll
      for (int j = 0; j < T::FN; ++j)
        wmma::load_matrix_sync(fb[j], b + kk * T::B_LD + wn * 32 + j * 16,
                               T::B_LD);
#pragma unroll
      for (int i = 0; i < T::FM; ++i)
#pragma unroll
        for (int j = 0; j < T::FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();  // no copy left in flight (an empty range issues one)

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
  constexpr int SBM = 64, SBN = 64, SBK = 16;
  __shared__ float As[SBK][SBM + 4];  // transposed: As[k][m]
  __shared__ float Bs[SBK][SBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = (blockIdx.x / n_col_tiles) * SBM;
  const int n0 = (blockIdx.x % n_col_tiles) * SBN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += SBK) {
    for (int e = tid; e < SBM * SBK; e += kThreads) {
      const int r = e / SBK, kk = e % SBK;
      const int gr = m0 + r, gk = k0 + kk;
      As[kk][r] = (gr < M && gk < K) ? P[(int64_t)gr * K + gk] : 0.f;
    }
    for (int e = tid; e < SBK * SBN; e += kThreads) {
      const int kk = e / SBN, cc = e % SBN;
      const int gk = k0 + kk, gc = n0 + cc;
      Bs[kk][cc] = (gk < K && gc < C) ? W[(int64_t)gk * C + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

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

int tile_n(int c) { return c <= 64 ? 64 : 128; }

// K range per split: a multiple of BK, so every split but the last is full
int k_chunk(int k, int splits) {
  const int per = (k + splits - 1) / splits;
  return (per + BK - 1) / BK * BK;
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
  if (in_dtype != dcgan::kBFloat16 || m <= 0 || c <= 0) return 1;
  const int bn = tile_n(c);
  const int64_t tiles = (int64_t)((m + BM - 1) / BM) * ((c + bn - 1) / bn);
  int splits = 1;
  // double while the doubled CTA count still fits two per SM at once
  while (tiles * (2 * splits) <= 2 * (int64_t)sm_count &&
         k >= 2 * splits * 256)
    splits *= 2;
  return splits;
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

// The GEMM main loops shared by gemm_bias_scale_act.cu (kernel 5) and
// gemm_bias_moments.cu (kernel 4): one CTA sums the product of a BM x BK
// strip of P and a BK x BN strip of W over a K range into registers. The
// two kernels differ only in their epilogues.
//
//   bf16 operands: a 128 x BN tile (BN = 128, or 64 when C <= 64), 8 warps
//   issuing WMMA 16x16x16 bf16 products with f32 accumulators, K walked in
//   steps of 32 through a two-stage cp.async ring in shared memory.
//   f32 operands: a 64 x 64 SIMT tile with 4 x 4 outputs per thread, full
//   f32 FMAs (the tensor cores' TF32 would drop mantissa bits).
//   Ragged M, K and C are masked: out-of-range loads fill zeros. cp.async
//   needs 16-byte chunks, so it is used only when K and C are multiples of
//   8 and P, W are 16-byte aligned; otherwise tiles load element by element.
#pragma once

#include <cstdint>

#include <mma.h>

#include "common.cuh"

namespace dcgan {
namespace gemm {

using namespace nvcuda;
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
  // the ring, then one 16 x 16 f32 epilogue scratch per warp
  static constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) *
                                        (int)sizeof(bf16) +
                                    8 * 256 * (int)sizeof(float);
};

using Frag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// acc[i][j] = P[m0 + rows, k_begin:k_end] @ W[k_begin:k_end, n0 + cols] for
// warp (wm, wn)'s fragments. As/Bs: the ring in shared memory. Leaves no
// cp.async in flight.
template <int BN>
__device__ __forceinline__ void wmma_tile_product(
    const bf16* __restrict__ P, const bf16* __restrict__ W, int M, int K,
    int C, int m0, int n0, int k_begin, int k_end, bool aligned, bf16* As,
    bf16* Bs, Frag (&acc)[Tile<BN>::FM][Tile<BN>::FN]) {
  using T = Tile<BN>;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
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
}

// f32 SIMT tile: 64 x 64 outputs, thread (ty, tx) of a 16 x 16 grid owns
// rows ty*4 .. +4 and columns tx*4 .. +4
constexpr int SBM = 64, SBN = 64, SBK = 16;

struct SimtSmem {
  float As[SBK][SBM + 4];  // transposed: As[k][m]
  float Bs[SBK][SBN + 4];
};

__device__ __forceinline__ void simt_tile_product(
    const float* __restrict__ P, const float* __restrict__ W, int M, int K,
    int C, int m0, int n0, SimtSmem& sm, float (&acc)[4][4]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += SBK) {
    for (int e = tid; e < SBM * SBK; e += kThreads) {
      const int r = e / SBK, kk = e % SBK;
      const int gr = m0 + r, gk = k0 + kk;
      sm.As[kk][r] = (gr < M && gk < K) ? P[(int64_t)gr * K + gk] : 0.f;
    }
    for (int e = tid; e < SBK * SBN; e += kThreads) {
      const int kk = e / SBN, cc = e % SBN;
      const int gk = k0 + kk, gc = n0 + cc;
      sm.Bs[kk][cc] = (gk < K && gc < C) ? W[(int64_t)gk * C + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm.As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sm.Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

inline int tile_n(int c) { return c <= 64 ? 64 : 128; }

// K range per split: a multiple of BK, so every split but the last is full
inline int k_chunk(int k, int splits) {
  const int per = (k + splits - 1) / splits;
  return (per + BK - 1) / BK * BK;
}

// The design codes of a launch plan (ops/fused.py::GBSA_DESIGNS), shared by
// gemm_bias_scale_act and gemm_bias_moments: f32 SIMT, v1 WMMA (this
// file's loop), v2 TMA + wgmma (gemm_wgmma.cuh)
enum Design : int { kSimt = 0, kWmma = 1, kWgmma = 2 };

using dcgan::aligned16;

}  // namespace gemm
}  // namespace dcgan

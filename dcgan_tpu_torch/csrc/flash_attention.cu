// Flash attention for the SAGAN block: forward, dq and dkv.
//
// Replaces the three TPU kernels of dcgan_tpu/ops/pallas_attention.py:
// `_fwd_kernel` (pl.pallas_call in `_fwd_impl`), `_dq_kernel` and
// `_dkv_kernel` (the two pl.pallas_calls of `_bwd_core`). On the sagan64
// path both nets call it with B = 64, S = 1024 (a 32x32 map), d_qk = 8 and
// d_v = 32, in bf16; sagan128 and sagan256-lc keep the heads at S = 4096
// and 16384.
//
// What each kernel computes (the TPU kernels' arithmetic):
// - forward, one CTA per (batch, 64 q rows), looping over 64-key tiles with
//   the online softmax: s = (q . k^T in f32) * scale, m starts at -1e30,
//   p = exp(s - m_new) in f32, l = l * corr + sum(p) over the f32 p,
//   acc = acc * corr + (p in the operand dtype) . v; out = acc / l (f32) and
//   lse = m + log l (f32);
// - dq, one CTA per (batch, 64 q rows), looping over 64-key tiles:
//   p = exp(s - lse), dp = do . v^T, ds = p * (dp - delta),
//   dq += ((ds in the operand dtype) . k) * scale; dq in q's dtype;
// - dkv, one CTA per (batch, 64 keys), walking every 64-row q tile:
//   dk += ((ds in the operand dtype)^T . q) * scale,
//   dv += (p in the operand dtype)^T . do; dk, dv in k's and v's dtypes.
// dq and dkv stay two kernels and write disjoint outputs: no atomics, so two
// launches give the same bits.
//
// Bound. Every score costs one exponential in each kernel (the backward
// recomputes p from lse). At sagan64's shape that is 64 * 1024^2 = 67 M
// exponentials per launch, ~16 us at 16 MUFU ex2 per clock per SM on 132 SMs
// at 1.98 GHz; the bytes (~15 MB for the forward, ~4.5 us) and the bf16
// products (~5 GFLOP, ~5 us) bound it less.
//
// Design. Each of the 4 warps of a CTA owns 16 rows of the CTA's tile.
// Products are 16 x 8 output tiles from shared memory: in bf16 one
// `mma.sync.m16n8k16` per 16-deep step (the narrow heads are zero-padded to
// 16 or 64 in shared memory, and d_v to 32 or 128); in f32 the same output
// fragment computed with f32 FMAs, so the f32 path is exact f32 (no TF32).
// Score fragments are reduced across the 4 lanes that share a row with
// shuffles; p and ds go through a per-warp shared tile in the operand dtype
// to become the next product's A operand. A ragged S is masked: keys past S
// score -inf (p = 0), q rows past S read lse = +inf and delta = 0 in dkv, and
// rows past S are not written.
// Still to do for speed: wgmma and TMA, keeping p in registers (the mma
// accumulator layout is the A layout of the next product), exp2 with the
// scale folded into log2(e), larger key tiles for the narrow heads.

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

using dcgan::from_float;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;              // rows of one warp's tile
constexpr int kTile = kWarps * kRows;  // q rows (fwd, dq) / keys (dkv) per CTA
constexpr int kInner = 64;             // keys (fwd, dq) / q rows (dkv) per step
constexpr float kNegInf = -1e30f;      // the running max's start (_NEG_INF)

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// C[16 x 8] += A[16 x 16 ksteps] . Bt[8 x 16 ksteps]^T for one warp, A and
// Bt row-major in shared memory with leading dimensions lda, ldb (even).
// The accumulator is the mma.sync m16n8 fragment: lane (g = lane / 4,
// t = lane % 4) holds c[0], c[1] at row g, columns 2t, 2t + 1 and c[2], c[3]
// at row g + 8.
template <typename T> struct WarpMma;

template <> struct WarpMma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(
      const __nv_bfloat16* a, int lda, const __nv_bfloat16* bt, int ldb,
      int ksteps, float c[4]) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const __nv_bfloat16* a_lo = a + g * lda + 2 * t;
    const __nv_bfloat16* a_hi = a_lo + 8 * lda;
    const __nv_bfloat16* b = bt + g * ldb + 2 * t;
    for (int ks = 0; ks < ksteps; ++ks) {
      const int k0 = ks * 16;
      const uint32_t a0 = ld32(a_lo + k0), a1 = ld32(a_hi + k0);
      const uint32_t a2 = ld32(a_lo + k0 + 8), a3 = ld32(a_hi + k0 + 8);
      const uint32_t b0 = ld32(b + k0), b1 = ld32(b + k0 + 8);
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};\n"
          : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
};

template <> struct WarpMma<float> {
  static __device__ __forceinline__ void run(const float* a, int lda,
                                             const float* bt, int ldb,
                                             int ksteps, float c[4]) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const float* a_lo = a + g * lda;
    const float* a_hi = a_lo + 8 * lda;
    const float* b_0 = bt + (2 * t) * ldb;
    const float* b_1 = b_0 + ldb;
    const int kd = ksteps * 16;
    for (int kk = 0; kk < kd; ++kk) {
      const float x0 = a_lo[kk], x1 = a_hi[kk], y0 = b_0[kk], y1 = b_1[kk];
      c[0] = fmaf(x0, y0, c[0]);
      c[1] = fmaf(x0, y1, c[1]);
      c[2] = fmaf(x1, y0, c[2]);
      c[3] = fmaf(x1, y1, c[3]);
    }
  }
};

// Shared-memory row padding: 16 bytes, so the 8 row groups of a fragment
// load fall in different banks.
template <typename T> constexpr int pad() { return 16 / (int)sizeof(T); }

// dst[r][c] = src[r0 + r][c] for r < rows, c < DP; zero past S or past d.
template <typename T, int DP>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          int r0, int S, int d, int rows) {
  for (int idx = threadIdx.x; idx < rows * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP;
    T val = from_float<T>(0.f);
    if (r0 + r < S && c < d) val = src[(int64_t)(r0 + r) * d + c];
    dst[r * ld + c] = val;
  }
}

// dst[c][r] = src[r0 + r][c] (the tile transposed), zero-padded likewise.
template <typename T, int DP>
__device__ __forceinline__ void load_cols(T* dst, int ld, const T* src,
                                          int r0, int S, int d, int rows) {
  for (int idx = threadIdx.x; idx < rows * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP;
    T val = from_float<T>(0.f);
    if (r0 + r < S && c < d) val = src[(int64_t)(r0 + r) * d + c];
    dst[c * ld + r] = val;
  }
}

// Fragment element i of n-tile n: row offset within the warp's 16 rows and
// column within the n-tile set.
__device__ __forceinline__ int frag_row(int i) {
  return ((threadIdx.x & 31) >> 2) + (i >= 2 ? 8 : 0);
}
__device__ __forceinline__ int frag_col(int n, int i) {
  return n * 8 + 2 * (threadIdx.x & 3) + (i & 1);
}

// Write a [16 x 8 NT] fragment set to a row-major shared tile, cast to T.
template <typename T, int NT>
__device__ __forceinline__ void store_frags(T* dst, int ld,
                                            const float (&f)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dst[frag_row(i) * ld + frag_col(n, i)] = from_float<T>(f[n][i]);
}

// Reduce v over the 4 lanes that hold one fragment row.
__device__ __forceinline__ float row_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <typename T, int DKP, int DVP>
struct FwdSmem {
  static constexpr int kLdK = DKP + pad<T>();     // q_s, k_s
  static constexpr int kLdT = kInner + pad<T>();  // vt_s, p_s
  static constexpr int kBytes =
      (int)sizeof(T) * ((kTile + kInner) * kLdK + DVP * kLdT
                        + kWarps * kRows * kLdT);
};

template <typename T, int DKP, int DVP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int S, int dk, int dv,
                 float scale) {
  using L = FwdSmem<T, DKP, DVP>;
  constexpr int NS = kInner / 8, NO = DVP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);        // [kTile][kLdK]
  T* k_s = q_s + kTile * L::kLdK;             // [kInner][kLdK]
  T* vt_s = k_s + kInner * L::kLdK;           // [DVP][kLdT], v transposed
  T* p_s = vt_s + DVP * L::kLdT;              // [kWarps][kRows][kLdT]

  const int b = blockIdx.y, q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5;
  const T* qb = q + (int64_t)b * S * dk;
  const T* kb = k + (int64_t)b * S * dk;
  const T* vb = v + (int64_t)b * S * dv;
  const T* q_w = q_s + warp * kRows * L::kLdK;
  T* p_w = p_s + warp * kRows * L::kLdT;

  load_rows<T, DKP>(q_s, L::kLdK, qb, q0, S, dk, kTile);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int j0 = 0; j0 < S; j0 += kInner) {
    __syncthreads();  // the previous step's reads of k_s, vt_s are done
    load_rows<T, DKP>(k_s, L::kLdK, kb, j0, S, dk, kInner);
    load_cols<T, DVP>(vt_s, L::kLdT, vb, j0, S, dv, kInner);
    __syncthreads();

    float s[NS][4];
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
      WarpMma<T>::run(q_w, L::kLdK, k_s + n * 8 * L::kLdK, L::kLdK,
                      DKP / 16, s[n]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = j0 + frag_col(n, i) < S ? s[n][i] * scale
                                                 : -INFINITY;
        s[n][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = row_max(mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = expf(s[n][i] - m[i >> 1]);
        sum[i >> 1] += s[n][i];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + row_sum(sum[r]);
    store_frags<T, NS>(p_w, L::kLdT, s);
    __syncwarp();
#pragma unroll
    for (int n = 0; n < NO; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] *= corr[i >> 1];
      WarpMma<T>::run(p_w, L::kLdT, vt_s + n * 8 * L::kLdT, L::kLdT,
                      kInner / 16, acc[n]);
    }
  }

  const int row0 = q0 + warp * kRows;
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + frag_row(i), col = frag_col(n, i);
      if (row < S && col < dv)
        out[((int64_t)b * S + row) * dv + col] = acc[n][i] / l[i >> 1];
    }
  if ((threadIdx.x & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + frag_row(2 * r);
      if (row < S) lse[(int64_t)b * S + row] = m[r] + logf(l[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

template <typename T, int DKP, int DVP>
struct DqSmem {
  static constexpr int kLdK = DKP + pad<T>();     // q_s, k_s
  static constexpr int kLdV = DVP + pad<T>();     // do_s, v_s
  static constexpr int kLdT = kInner + pad<T>();  // kt_s, ds_s
  static constexpr int kBytes =
      (int)sizeof(T) * ((kTile + kInner) * (kLdK + kLdV) + DKP * kLdT
                        + kWarps * kRows * kLdT);
};

template <typename T, int DKP, int DVP>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int S,
                int dk, int dv, float scale) {
  using L = DqSmem<T, DKP, DVP>;
  constexpr int NS = kInner / 8, NQ = DKP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);        // [kTile][kLdK]
  T* do_s = q_s + kTile * L::kLdK;            // [kTile][kLdV]
  T* k_s = do_s + kTile * L::kLdV;            // [kInner][kLdK]
  T* v_s = k_s + kInner * L::kLdK;            // [kInner][kLdV]
  T* kt_s = v_s + kInner * L::kLdV;           // [DKP][kLdT], k transposed
  T* ds_s = kt_s + DKP * L::kLdT;             // [kWarps][kRows][kLdT]

  const int b = blockIdx.y, q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5;
  const T* kb = k + (int64_t)b * S * dk;
  const T* vb = v + (int64_t)b * S * dv;
  load_rows<T, DKP>(q_s, L::kLdK, q + (int64_t)b * S * dk, q0, S, dk, kTile);
  load_rows<T, DVP>(do_s, L::kLdV, dout + (int64_t)b * S * dv, q0, S, dv,
                    kTile);
  const T* q_w = q_s + warp * kRows * L::kLdK;
  const T* do_w = do_s + warp * kRows * L::kLdV;
  T* ds_w = ds_s + warp * kRows * L::kLdT;

  const int row0 = q0 + warp * kRows;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + frag_row(2 * r);
    lse_r[r] = row < S ? lse[(int64_t)b * S + row] : 0.f;
    delta_r[r] = row < S ? delta[(int64_t)b * S + row] : 0.f;
  }
  float acc[NQ][4];
#pragma unroll
  for (int n = 0; n < NQ; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int j0 = 0; j0 < S; j0 += kInner) {
    __syncthreads();
    load_rows<T, DKP>(k_s, L::kLdK, kb, j0, S, dk, kInner);
    load_rows<T, DVP>(v_s, L::kLdV, vb, j0, S, dv, kInner);
    load_cols<T, DKP>(kt_s, L::kLdT, kb, j0, S, dk, kInner);
    __syncthreads();

    float ds[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
      WarpMma<T>::run(q_w, L::kLdK, k_s + n * 8 * L::kLdK, L::kLdK,
                      DKP / 16, s);
      WarpMma<T>::run(do_w, L::kLdV, v_s + n * 8 * L::kLdV, L::kLdV,
                      DVP / 16, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = j0 + frag_col(n, i) < S
                            ? expf(s[i] * scale - lse_r[i >> 1]) : 0.f;
        ds[n][i] = p * (dp[i] - delta_r[i >> 1]);
      }
    }
    store_frags<T, NS>(ds_w, L::kLdT, ds);
    __syncwarp();
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      WarpMma<T>::run(ds_w, L::kLdT, kt_s + n * 8 * L::kLdT, L::kLdT,
                      kInner / 16, part);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] += part[i] * scale;
    }
  }

#pragma unroll
  for (int n = 0; n < NQ; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + frag_row(i), col = frag_col(n, i);
      if (row < S && col < dk)
        dq[((int64_t)b * S + row) * dk + col] = from_float<T>(acc[n][i]);
    }
}

// ---------------------------------------------------------------------------
// dk, dv
// ---------------------------------------------------------------------------

template <typename T, int DKP, int DVP>
struct DkvSmem {
  static constexpr int kLdK = DKP + pad<T>();     // k_s, q_s
  static constexpr int kLdV = DVP + pad<T>();     // v_s, do_s
  static constexpr int kLdT = kInner + pad<T>();  // qt_s, dot_s, w_s
  static constexpr int kBytes =
      (int)sizeof(T) * ((kTile + kInner) * (kLdK + kLdV)
                        + (DKP + DVP + kWarps * kRows) * kLdT)
      + 2 * kInner * (int)sizeof(float);
};

template <typename T, int DKP, int DVP>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk_out,
                 T* __restrict__ dv_out, int S, int dk, int dv,
                 float scale) {
  using L = DkvSmem<T, DKP, DVP>;
  constexpr int NS = kInner / 8, NK = DKP / 8, NV = DVP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* lse_s = reinterpret_cast<float*>(smem);  // [kInner]
  float* delta_s = lse_s + kInner;                // [kInner]
  T* k_s = reinterpret_cast<T*>(delta_s + kInner);  // [kTile][kLdK]
  T* v_s = k_s + kTile * L::kLdK;                 // [kTile][kLdV]
  T* q_s = v_s + kTile * L::kLdV;                 // [kInner][kLdK]
  T* do_s = q_s + kInner * L::kLdK;               // [kInner][kLdV]
  T* qt_s = do_s + kInner * L::kLdV;              // [DKP][kLdT]
  T* dot_s = qt_s + DKP * L::kLdT;                // [DVP][kLdT]
  T* w_s = dot_s + DVP * L::kLdT;                 // [kWarps][kRows][kLdT]

  const int b = blockIdx.y, j0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5;
  const T* qb = q + (int64_t)b * S * dk;
  const T* dob = dout + (int64_t)b * S * dv;
  load_rows<T, DKP>(k_s, L::kLdK, k + (int64_t)b * S * dk, j0, S, dk, kTile);
  load_rows<T, DVP>(v_s, L::kLdV, v + (int64_t)b * S * dv, j0, S, dv, kTile);
  const T* k_w = k_s + warp * kRows * L::kLdK;
  const T* v_w = v_s + warp * kRows * L::kLdV;
  T* w_w = w_s + warp * kRows * L::kLdT;

  float dk_acc[NK][4], dv_acc[NV][4];
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[n][i] = 0.f;
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dv_acc[n][i] = 0.f;

  for (int i0 = 0; i0 < S; i0 += kInner) {
    __syncthreads();
    load_rows<T, DKP>(q_s, L::kLdK, qb, i0, S, dk, kInner);
    load_rows<T, DVP>(do_s, L::kLdV, dob, i0, S, dv, kInner);
    load_cols<T, DKP>(qt_s, L::kLdT, qb, i0, S, dk, kInner);
    load_cols<T, DVP>(dot_s, L::kLdT, dob, i0, S, dv, kInner);
    for (int r = threadIdx.x; r < kInner; r += kThreads) {
      const bool in = i0 + r < S;
      // rows past S: p = exp(s - inf) = 0, and with do = 0 there, ds = 0
      lse_s[r] = in ? lse[(int64_t)b * S + i0 + r] : INFINITY;
      delta_s[r] = in ? delta[(int64_t)b * S + i0 + r] : 0.f;
    }
    __syncthreads();

    // transposed scores: rows are this warp's 16 keys, columns q rows
    float p[NS][4], ds[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
      WarpMma<T>::run(k_w, L::kLdK, q_s + n * 8 * L::kLdK, L::kLdK,
                      DKP / 16, s);
      WarpMma<T>::run(v_w, L::kLdV, do_s + n * 8 * L::kLdV, L::kLdV,
                      DVP / 16, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = frag_col(n, i);
        p[n][i] = expf(s[i] * scale - lse_s[col]);
        ds[n][i] = p[n][i] * (dp[i] - delta_s[col]);
      }
    }
    store_frags<T, NS>(w_w, L::kLdT, p);
    __syncwarp();
#pragma unroll
    for (int n = 0; n < NV; ++n)
      WarpMma<T>::run(w_w, L::kLdT, dot_s + n * 8 * L::kLdT, L::kLdT,
                      kInner / 16, dv_acc[n]);
    __syncwarp();
    store_frags<T, NS>(w_w, L::kLdT, ds);
    __syncwarp();
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      WarpMma<T>::run(w_w, L::kLdT, qt_s + n * 8 * L::kLdT, L::kLdT,
                      kInner / 16, part);
#pragma unroll
      for (int i = 0; i < 4; ++i) dk_acc[n][i] += part[i] * scale;
    }
  }

  const int row0 = j0 + warp * kRows;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + frag_row(i);
    if (row >= S) continue;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      const int col = frag_col(n, i);
      if (col < dk)
        dk_out[((int64_t)b * S + row) * dk + col] =
            from_float<T>(dk_acc[n][i]);
    }
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int col = frag_col(n, i);
      if (col < dv)
        dv_out[((int64_t)b * S + row) * dv + col] =
            from_float<T>(dv_acc[n][i]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int bytes) {
  // above 48 KB a block's shared memory must be asked for
  if (bytes > 48 * 1024)
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return cudaSuccess;
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *out0, *out1;
  int b, s, dk, dv;
  float scale;
  cudaStream_t stream;
};

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int DKP, int DVP>
cudaError_t launch(Which which, const Args& a) {
  const dim3 grid((a.s + kTile - 1) / kTile, a.b);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* d = static_cast<const T*>(a.dout);
  cudaError_t err;
  if (which == kFwd) {
    const int bytes = FwdSmem<T, DKP, DVP>::kBytes;
    if ((err = prepare(flash_fwd_kernel<T, DKP, DVP>, bytes))) return err;
    flash_fwd_kernel<T, DKP, DVP><<<grid, kThreads, bytes, a.stream>>>(
        q, k, v, static_cast<float*>(a.out0), static_cast<float*>(a.out1),
        a.s, a.dk, a.dv, a.scale);
  } else if (which == kDq) {
    const int bytes = DqSmem<T, DKP, DVP>::kBytes;
    if ((err = prepare(flash_dq_kernel<T, DKP, DVP>, bytes))) return err;
    flash_dq_kernel<T, DKP, DVP><<<grid, kThreads, bytes, a.stream>>>(
        q, k, v, d, a.lse, a.delta, static_cast<T*>(a.out0), a.s, a.dk,
        a.dv, a.scale);
  } else {
    const int bytes = DkvSmem<T, DKP, DVP>::kBytes;
    if ((err = prepare(flash_dkv_kernel<T, DKP, DVP>, bytes))) return err;
    flash_dkv_kernel<T, DKP, DVP><<<grid, kThreads, bytes, a.stream>>>(
        q, k, v, d, a.lse, a.delta, static_cast<T*>(a.out0),
        static_cast<T*>(a.out1), a.s, a.dk, a.dv, a.scale);
  }
  return cudaGetLastError();
}

// The head widths are padded to one of two sizes each: d_qk to 16 (SAGAN's
// C/8 at C <= 128) or 64, d_v to 32 (C/2 at C <= 64) or 128.
template <typename T>
cudaError_t dispatch(Which which, const Args& a) {
  if (a.dk <= 16) {
    return a.dv <= 32 ? launch<T, 16, 32>(which, a)
                      : launch<T, 16, 128>(which, a);
  }
  return a.dv <= 32 ? launch<T, 64, 32>(which, a)
                    : launch<T, 64, 128>(which, a);
}

int run(Which which, const Args& a, int dtype) {
  if (a.b <= 0 || a.s <= 0) return (int)cudaSuccess;
  if (a.b > 65535 || a.dk < 1 || a.dk > 64 || a.dv < 1 || a.dv > 128)
    return (int)cudaErrorInvalidValue;
  if (dtype == dcgan::kFloat32) return (int)dispatch<float>(which, a);
  if (dtype == dcgan::kBFloat16)
    return (int)dispatch<__nv_bfloat16>(which, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface for ctypes; each returns a cudaError_t (0 = launched). q, k
// [b, s, dk], v [b, s, dv] and do [b, s, dv] share one dtype (0 = float32,
// 1 = bfloat16), contiguous; lse and delta are f32 [b, s].

// out f32 [b, s, dv], lse f32 [b, s]
extern "C" int dcgan_flash_fwd(const void* q, const void* k, const void* v,
                               float* out, float* lse, int b, int s, int dk,
                               int dv, int dtype, float scale,
                               void* stream) {
  const Args a{q, k, v, nullptr, nullptr, nullptr, out, lse, b, s, dk, dv,
               scale, static_cast<cudaStream_t>(stream)};
  return run(kFwd, a, dtype);
}

// dq [b, s, dk] in the inputs' dtype
extern "C" int dcgan_flash_dq(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dq, int b, int s,
                              int dk, int dv, int dtype, float scale,
                              void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, b, s, dk, dv, scale,
               static_cast<cudaStream_t>(stream)};
  return run(kDq, a, dtype);
}

// dk [b, s, dk] and dv [b, s, dv] in the inputs' dtype
extern "C" int dcgan_flash_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, void* dk_out,
                               void* dv_out, int b, int s, int dk, int dv,
                               int dtype, float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk_out, dv_out, b, s, dk, dv,
               scale, static_cast<cudaStream_t>(stream)};
  return run(kDkv, a, dtype);
}

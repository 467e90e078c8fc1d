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
// - forward, one CTA per (batch, tile of q rows), looping over key tiles
//   with the online softmax: s = (q . k^T in f32) * scale, m starts at
//   -1e30, p = exp(s - m_new) in f32, l = l * corr + sum(p) over the f32 p,
//   acc = acc * corr + (p in the operand dtype) . v; out = acc / l (f32) and
//   lse = m + log l (f32, natural-log units);
// - dq, one CTA per (batch, tile of q rows), looping over key tiles:
//   p = exp(s - lse), dp = do . v^T, ds = p * (dp - delta),
//   dq += ((ds in the operand dtype) . k) * scale; dq in q's dtype;
// - dkv, one CTA per (batch, tile of keys), walking every q tile:
//   dk = ((ds in the operand dtype)^T . q) * scale,
//   dv = (p in the operand dtype)^T . do; dk, dv in k's and v's dtypes.
// With bf16 operands dq and dkv may instead write their f32 accumulators
// as f32 (out_dtype 0): the ring backward's per-hop terms, which it sums
// across hops before one rounding (`_bwd_core(grad_dtype=jnp.float32)`);
// the OutT template argument of the bf16 kernels.
// dq and dkv stay two kernels and write disjoint outputs: no atomics, so two
// launches give the same bits.
//
// Bound. Every score costs one exponential in each kernel (the backward
// recomputes p from lse). At sagan64's shape that is 64 * 1024^2 = 67 M
// exponentials per launch, ~16 us at 16 MUFU ex2 per clock per SM on 132 SMs
// at 1.98 GHz; the bytes (~15 MB for the forward, ~4.5 us) and the bf16
// products (~5 GFLOP, ~5 us at the wgmma peak) bound it less.
//
// bf16 forward, dq and dkv (the sagan64 path). MUFU, which runs ex2, takes 16
// lanes per clock per SM against 128 FP32 lanes, so a score's FP32 work
// around its ex2 is hidden only if it stays a few instructions. Beside the
// exponentials each kernel streams its B operands out of shared memory
// with ldmatrix (k and v in the forward, ~12 us at sagan64's shape at 128
// bytes per clock per SM with one 16-row tile per warp) and runs its
// products on mma.sync, well under the wgmma peak (dkv has four products
// per score tile); these share the SM's dispatch slots with the exponentials
// and do not all overlap. The design:
// - Tile loads are 16-byte cp.async into row-major shared tiles padded by
//   16 bytes a row (ldmatrix reads them without bank conflicts), two
//   stages: the next key tile (forward, dq) or q tile (dkv) is in flight
//   while this one is computed, with one __syncthreads per tile. The
//   operands the products need transposed (v for p.v; k for ds.k; q and do
//   for dk and dv) are read from the same row-major tiles with
//   ldmatrix.trans, never copied transposed. cp.async needs 16-byte rows and pointers: d_qk and d_v
//   multiples of 8 and q, k, v (and do) 16-byte aligned. Any other width or
//   pointer takes a scalar load path of the same kernel into the same
//   zero-padded tiles; everything after the load is shared.
// - p, and in dq and dkv ds, stay in registers: the m16n8 accumulators of
//   two adjacent n8 tiles, packed with cvt.rn.bf16x2.f32, are the A
//   fragment of the next k16 product.
// - exp2: the scores stay raw q . k sums and p = ex2.approx(s * c - m) is
//   one FFMA and one MUFU op, c = scale * log2(e), the running max m kept in
//   log2 units (a negative scale is moved into q's fragments, an exact sign
//   flip, so the max is taken with c > 0). lse = (m + log2 l) * ln 2 is
//   written in natural-log units for the backward and the plain versions;
//   dq and dkv take lse * log2(e) once per q row, p = ex2(s * c - lse2)
//   (no max, so a negative c is used as it is), and scale dq and dk once,
//   at the write.
// - Only the ragged last key tile of the forward and of dq is masked (keys
//   past S score -inf, or get p = 0). dkv masks nothing: q rows past S are
//   zero-filled and read lse = +inf (p = 0) and delta = 0, as dq's rows
//   past S do.
// - Forward: 4 warps per CTA, each owning two 16-row m tiles (128 q rows
//   per CTA), walking 128-key tiles; q's A fragments are held in registers
//   for the whole walk, and each k or v fragment read from shared memory
//   feeds both m tiles' products. A lane's row max and row sum run as 4
//   interleaved partials (short dependency chains); the max is reduced
//   across a row's 4 lanes every tile, the sum kept per lane and reduced
//   once at the end.
// - dkv: 8 warps per CTA, each owning two 16-key m tiles (256 keys per
//   CTA), k's and v's A fragments held in registers for the whole walk
//   over 64-row q tiles. The scores are transposed (rows keys, columns q
//   rows), so s^T and ds^T come out as the A operands of dv += p^T . do and
//   dk += ds^T . q; q rows are taken 16 at a time, so the registers do not
//   grow with the q tile, and dk's products run only over the n8 tiles
//   d_qk needs.
// - dq: 8 warps per CTA, each owning two 16-row m tiles (256 q rows per
//   CTA), walking 128-key tiles 16 keys at a time; q's and do's A
//   fragments are held in registers for the whole walk, s and dp of one
//   16-key step live only for that step (so the registers do not grow with
//   the key tile), and each k or v fragment read from shared memory feeds
//   both m tiles' products; dq's products run only over the n8 tiles d_qk
//   needs (one at d_qk = 8).
// - Tile shapes from tile sweeps on the card (PERF.md): 128-key forward
//   tiles 6-14 % faster than 64, two m tiles per warp 3-5 % faster than
//   one in the forward and 1-4 % in dkv; dq's constants from its own
//   sweep.
//   The narrow heads' kernels (d_qk <= 16, d_v <= 32) use 255 and 176
//   registers and keep 8 warps per SM; the wide heads keep one m tile per
//   warp, as two would not fit in 255 registers.
// - No wgmma: it wants 64-row warpgroup tiles and shared-memory B
//   descriptors, the bound is MUFU, and at sagan64's shape the products at
//   the wgmma peak take ~5 us of the 16 us bound; mma.sync with p in
//   registers keeps them below the exponentials in the forward.
//
// The f32 kernels of all three (the exact-f32 test path) keep the first
// design: each of the 4 warps of a CTA owns 16 rows of the CTA's tile;
// products are 16 x 8 output tiles from shared memory computed with f32
// FMAs in the m16n8 fragment layout (the narrow heads zero-padded to 16 or
// 64 in shared memory, and d_v to 32 or 128), so the f32 path is exact f32
// (no TF32). Score fragments are reduced across the 4 lanes that share a
// row with shuffles; p and ds go through a per-warp shared tile to become
// the next product's A operand. Tiles are loaded element by element, k
// transposed by the copy. Keys past S score -inf (p = 0), q rows past S
// read lse = +inf and delta = 0, and rows past S are not written.
// Still to do for speed: wgmma with a producer warp and TMA for all three.

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

using dcgan::from_float;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;              // rows of one warp's tile
constexpr int kTile = kWarps * kRows;  // q rows (fwd, dq) / keys (dkv) per CTA
constexpr int kInner = 64;             // keys (fwd, dq) / q rows (dkv) per step
constexpr float kNegInf = -1e30f;      // the running max's start (_NEG_INF)

// C[16 x 8] += A[16 x 16 ksteps] . Bt[8 x 16 ksteps]^T for one warp in f32
// FMAs, A and Bt row-major in shared memory with leading dimensions lda,
// ldb.
// The accumulator is the mma.sync m16n8 fragment: lane (g = lane / 4,
// t = lane % 4) holds c[0], c[1] at row g, columns 2t, 2t + 1 and c[2], c[3]
// at row g + 8.
template <typename T> struct WarpMma;

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
// Forward, f32
// ---------------------------------------------------------------------------

template <int DKP, int DVP>
struct FwdSmem {
  static constexpr int kLdK = DKP + pad<float>();     // q_s, k_s
  static constexpr int kLdT = kInner + pad<float>();  // vt_s, p_s
  static constexpr int kBytes =
      (int)sizeof(float) * ((kTile + kInner) * kLdK + DVP * kLdT
                            + kWarps * kRows * kLdT);
};

template <int DKP, int DVP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_simt_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      float* __restrict__ lse, int S, int dk, int dv,
                      float scale) {
  using L = FwdSmem<DKP, DVP>;
  constexpr int NS = kInner / 8, NO = DVP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [kTile][kLdK]
  float* k_s = q_s + kTile * L::kLdK;           // [kInner][kLdK]
  float* vt_s = k_s + kInner * L::kLdK;  // [DVP][kLdT], v transposed
  float* p_s = vt_s + DVP * L::kLdT;     // [kWarps][kRows][kLdT]

  const int b = blockIdx.y, q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5;
  const float* qb = q + (int64_t)b * S * dk;
  const float* kb = k + (int64_t)b * S * dk;
  const float* vb = v + (int64_t)b * S * dv;
  const float* q_w = q_s + warp * kRows * L::kLdK;
  float* p_w = p_s + warp * kRows * L::kLdT;

  load_rows<float, DKP>(q_s, L::kLdK, qb, q0, S, dk, kTile);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int j0 = 0; j0 < S; j0 += kInner) {
    __syncthreads();  // the previous step's reads of k_s, vt_s are done
    load_rows<float, DKP>(k_s, L::kLdK, kb, j0, S, dk, kInner);
    load_cols<float, DVP>(vt_s, L::kLdT, vb, j0, S, dv, kInner);
    __syncthreads();

    float s[NS][4];
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
      WarpMma<float>::run(q_w, L::kLdK, k_s + n * 8 * L::kLdK, L::kLdK,
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
    store_frags<float, NS>(p_w, L::kLdT, s);
    __syncwarp();
#pragma unroll
    for (int n = 0; n < NO; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] *= corr[i >> 1];
      WarpMma<float>::run(p_w, L::kLdT, vt_s + n * 8 * L::kLdT, L::kLdT,
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
// dq, f32
// ---------------------------------------------------------------------------

template <int DKP, int DVP>
struct DqSmem {
  static constexpr int kLdK = DKP + pad<float>();     // q_s, k_s
  static constexpr int kLdV = DVP + pad<float>();     // do_s, v_s
  static constexpr int kLdT = kInner + pad<float>();  // kt_s, ds_s
  static constexpr int kBytes =
      (int)sizeof(float) * ((kTile + kInner) * (kLdK + kLdV) + DKP * kLdT
                        + kWarps * kRows * kLdT);
};

template <int DKP, int DVP>
__global__ void __launch_bounds__(kThreads)
flash_dq_simt_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dq, int S, int dk, int dv,
                     float scale) {
  using L = DqSmem<DKP, DVP>;
  constexpr int NS = kInner / 8, NQ = DKP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [kTile][kLdK]
  float* do_s = q_s + kTile * L::kLdK;          // [kTile][kLdV]
  float* k_s = do_s + kTile * L::kLdV;          // [kInner][kLdK]
  float* v_s = k_s + kInner * L::kLdK;          // [kInner][kLdV]
  float* kt_s = v_s + kInner * L::kLdV;         // [DKP][kLdT], k transposed
  float* ds_s = kt_s + DKP * L::kLdT;           // [kWarps][kRows][kLdT]

  const int b = blockIdx.y, q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5;
  const float* kb = k + (int64_t)b * S * dk;
  const float* vb = v + (int64_t)b * S * dv;
  load_rows<float, DKP>(q_s, L::kLdK, q + (int64_t)b * S * dk, q0, S, dk,
                        kTile);
  load_rows<float, DVP>(do_s, L::kLdV, dout + (int64_t)b * S * dv, q0, S, dv,
                        kTile);
  const float* q_w = q_s + warp * kRows * L::kLdK;
  const float* do_w = do_s + warp * kRows * L::kLdV;
  float* ds_w = ds_s + warp * kRows * L::kLdT;

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
    load_rows<float, DKP>(k_s, L::kLdK, kb, j0, S, dk, kInner);
    load_rows<float, DVP>(v_s, L::kLdV, vb, j0, S, dv, kInner);
    load_cols<float, DKP>(kt_s, L::kLdT, kb, j0, S, dk, kInner);
    __syncthreads();

    float ds[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
      WarpMma<float>::run(q_w, L::kLdK, k_s + n * 8 * L::kLdK, L::kLdK,
                          DKP / 16, s);
      WarpMma<float>::run(do_w, L::kLdV, v_s + n * 8 * L::kLdV, L::kLdV,
                          DVP / 16, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = j0 + frag_col(n, i) < S
                            ? expf(s[i] * scale - lse_r[i >> 1]) : 0.f;
        ds[n][i] = p * (dp[i] - delta_r[i >> 1]);
      }
    }
    store_frags<float, NS>(ds_w, L::kLdT, ds);
    __syncwarp();
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      WarpMma<float>::run(ds_w, L::kLdT, kt_s + n * 8 * L::kLdT, L::kLdT,
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
        dq[((int64_t)b * S + row) * dk + col] = acc[n][i];
    }
}

// ---------------------------------------------------------------------------
// dk, dv, f32
// ---------------------------------------------------------------------------

template <int DKP, int DVP>
struct DkvSmem {
  static constexpr int kLdK = DKP + pad<float>();     // k_s, q_s
  static constexpr int kLdV = DVP + pad<float>();     // v_s, do_s
  static constexpr int kLdT = kInner + pad<float>();  // qt_s, dot_s, w_s
  static constexpr int kBytes =
      (int)sizeof(float) * ((kTile + kInner) * (kLdK + kLdV)
                            + (DKP + DVP + kWarps * kRows) * kLdT
                            + 2 * kInner);
};

template <int DKP, int DVP>
__global__ void __launch_bounds__(kThreads)
flash_dkv_simt_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dk_out, float* __restrict__ dv_out,
                      int S, int dk, int dv, float scale) {
  using L = DkvSmem<DKP, DVP>;
  constexpr int NS = kInner / 8, NK = DKP / 8, NV = DVP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* lse_s = reinterpret_cast<float*>(smem);  // [kInner]
  float* delta_s = lse_s + kInner;                // [kInner]
  float* k_s = delta_s + kInner;                  // [kTile][kLdK]
  float* v_s = k_s + kTile * L::kLdK;             // [kTile][kLdV]
  float* q_s = v_s + kTile * L::kLdV;             // [kInner][kLdK]
  float* do_s = q_s + kInner * L::kLdK;           // [kInner][kLdV]
  float* qt_s = do_s + kInner * L::kLdV;          // [DKP][kLdT]
  float* dot_s = qt_s + DKP * L::kLdT;            // [DVP][kLdT]
  float* w_s = dot_s + DVP * L::kLdT;             // [kWarps][kRows][kLdT]

  const int b = blockIdx.y, j0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5;
  const float* qb = q + (int64_t)b * S * dk;
  const float* dob = dout + (int64_t)b * S * dv;
  load_rows<float, DKP>(k_s, L::kLdK, k + (int64_t)b * S * dk, j0, S, dk,
                        kTile);
  load_rows<float, DVP>(v_s, L::kLdV, v + (int64_t)b * S * dv, j0, S, dv,
                        kTile);
  const float* k_w = k_s + warp * kRows * L::kLdK;
  const float* v_w = v_s + warp * kRows * L::kLdV;
  float* w_w = w_s + warp * kRows * L::kLdT;

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
    load_rows<float, DKP>(q_s, L::kLdK, qb, i0, S, dk, kInner);
    load_rows<float, DVP>(do_s, L::kLdV, dob, i0, S, dv, kInner);
    load_cols<float, DKP>(qt_s, L::kLdT, qb, i0, S, dk, kInner);
    load_cols<float, DVP>(dot_s, L::kLdT, dob, i0, S, dv, kInner);
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
      WarpMma<float>::run(k_w, L::kLdK, q_s + n * 8 * L::kLdK, L::kLdK,
                          DKP / 16, s);
      WarpMma<float>::run(v_w, L::kLdV, do_s + n * 8 * L::kLdV, L::kLdV,
                          DVP / 16, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = frag_col(n, i);
        p[n][i] = expf(s[i] * scale - lse_s[col]);
        ds[n][i] = p[n][i] * (dp[i] - delta_s[col]);
      }
    }
    store_frags<float, NS>(w_w, L::kLdT, p);
    __syncwarp();
#pragma unroll
    for (int n = 0; n < NV; ++n)
      WarpMma<float>::run(w_w, L::kLdT, dot_s + n * 8 * L::kLdT, L::kLdT,
                          kInner / 16, dv_acc[n]);
    __syncwarp();
    store_frags<float, NS>(w_w, L::kLdT, ds);
    __syncwarp();
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      WarpMma<float>::run(w_w, L::kLdT, qt_s + n * 8 * L::kLdT, L::kLdT,
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
        dk_out[((int64_t)b * S + row) * dk + col] = dk_acc[n][i];
    }
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int col = frag_col(n, i);
      if (col < dv)
        dv_out[((int64_t)b * S + row) * dv + col] = dv_acc[n][i];
    }
  }
}

// ===========================================================================
// bf16 forward and dkv
// ===========================================================================

// Tile constants, chosen on the card by a tile sweep (PERF.md)
constexpr int kFwdWarps = 4;
constexpr int kFwdThreads = kFwdWarps * 32;
constexpr int kFwdKeys = 128;   // keys per tile
constexpr int kFwdMTiles = 2;   // 16-row m tiles per warp (narrow heads)
constexpr int kDkvWarps = 8;
constexpr int kDkvThreads = kDkvWarps * 32;
constexpr int kDkvMTiles = 2;   // 16-key m tiles per warp (narrow heads)
constexpr int kDkvRows = 64;                    // q rows per tile
constexpr int kDqWarps = 8;
constexpr int kDqThreads = kDqWarps * 32;
constexpr int kDqKeys = 128;    // keys per tile
constexpr int kDqMTiles = 2;    // 16-row m tiles per warp (narrow heads)
constexpr int kPadH = 8;                        // 16 bytes of row padding
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
static_assert(kFwdKeys % 16 == 0 && kDqKeys % 16 == 0
                  && kDkvRows <= kDkvThreads,
              "tile constants");

// 16-row m tiles per warp: the tile constant for the narrow heads
// (d_qk <= 16, d_v <= 32), 1 for the wide ones, whose accumulators would
// not fit twice in 255 registers
template <int DKP, int DVP, int MT>
constexpr int mtiles() {
  return DKP <= 16 && DVP <= 32 ? MT : 1;
}

// CTAs per SM that __launch_bounds__ asks registers for: 16 warps' worth
// of m tiles for the narrow heads, 8 for the wide ones, at least one CTA
template <int DKP, int DVP, int WARPS, int MT>
struct MinBlocks {
  static constexpr int n = (DKP <= 16 && DVP <= 32 ? 16 : 8) / (WARPS * MT);
  static constexpr int value = n > 0 ? n : 1;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; bytes < 16 zero-fills the rest
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ldmatrix: four (x4) or two (x2) 8 x 8 b16 matrices, lane i addressing
// row i % 8 of matrix i / 8; .trans hands each lane the transposed pairs
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

// c[16 x 8] += a[16 x 16] . b[16 x 8], bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (lo, hi) rounded to bf16, lo in the low half: two adjacent columns of an
// accumulator fragment as one register of an A fragment
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// row[col], row[col + 1] = x0, x1 where inside d columns; one store for
// an even d
__device__ __forceinline__ void store_pair(float* row, int col, int d,
                                           float x0, float x1) {
  if ((d & 1) == 0) {
    if (col < d) *reinterpret_cast<float2*>(row + col) = make_float2(x0, x1);
    return;
  }
  if (col < d) row[col] = x0;
  if (col + 1 < d) row[col + 1] = x1;
}
__device__ __forceinline__ void store_pair(bf16* row, int col, int d,
                                           float x0, float x1) {
  if ((d & 1) == 0) {
    if (col < d) *reinterpret_cast<uint32_t*>(row + col) = pack_bf16(x0, x1);
    return;
  }
  if (col < d) row[col] = from_float<bf16>(x0);
  if (col + 1 < d) row[col + 1] = from_float<bf16>(x1);
}

// dst[r][c] = src[(r0 + r) * d + c] for r < ROWS, c < DP, into a row-major
// shared tile with leading dimension ld; zero where r0 + r >= S or c >= d.
// vec: one 16-byte cp.async per 8 columns (the launch has checked that d is
// a multiple of 8 and src 16-byte aligned); else element by element.
template <int ROWS, int DP, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          int r0, int S, int d, bool vec) {
  if (vec) {
    constexpr int kChunks = DP / 8, kTotal = ROWS * kChunks;
#pragma unroll
    for (int i = 0; i < (kTotal + NT - 1) / NT; ++i) {
      const int idx = threadIdx.x + i * NT;
      if (kTotal % NT == 0 || idx < kTotal) {
        const int r = idx / kChunks, c = idx % kChunks * 8;
        const bool in = r0 + r < S && c < d;
        cp_async16(smem_u32(dst + r * ld + c),
                   in ? src + (int64_t)(r0 + r) * d + c : src, in ? 16 : 0);
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * DP; idx += NT) {
      const int r = idx / DP, c = idx % DP;
      bf16 val = from_float<bf16>(0.f);
      if (r0 + r < S && c < d) val = src[(int64_t)(r0 + r) * d + c];
      dst[r * ld + c] = val;
    }
  }
}

// Lane offsets of the ldmatrix.x4 addresses. A fragments and .trans B
// fragments: matrices (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15),
// (8-15, 8-15). Plain B fragments of two n8 tiles from row-major
// [n][k] rows: (0-7, 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15).
__device__ __forceinline__ int a_row() {
  return (threadIdx.x & 7) + (threadIdx.x & 8);
}
__device__ __forceinline__ int a_col() { return (threadIdx.x & 16) >> 1; }
__device__ __forceinline__ int b_row() {
  return (threadIdx.x & 7) + ((threadIdx.x & 16) >> 1);
}
__device__ __forceinline__ int b_col() { return threadIdx.x & 8; }

template <int DKP, int DVP>
struct FwdLayout {
  static constexpr int kMT = mtiles<DKP, DVP, kFwdMTiles>();
  static constexpr int kRowsCta = kFwdWarps * kMT * kRows;  // q rows
  static constexpr int kLdK = DKP + kPadH, kLdV = DVP + kPadH;
  static constexpr int kStage = kFwdKeys * (kLdK + kLdV);  // k, v elements
  static constexpr int kBytes = 2 * (kRowsCta * kLdK + 2 * kStage);
};

// One warp's kMT x 16 q rows against one key tile: s = q . k^T (raw
// sums), the online softmax in log2 units, acc = acc * corr + bf16(p) . v
// with p packed into A fragments in registers; each k and v fragment
// loaded once serves every m tile. MASK: keys past S score -inf.
template <int DKP, int DVP, bool MASK, int MT>
__device__ __forceinline__ void fwd_tile(
    const uint32_t (&qa)[MT][DKP / 16][4], const bf16* k_t, const bf16* v_t,
    int j0, int S, float c, float (&acc)[MT][DVP / 8][4], float (&m)[MT][2],
    float (&l)[MT][2]) {
  using L = FwdLayout<DKP, DVP>;
  constexpr int NS = kFwdKeys / 8;
  float s[MT][NS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[mt][n][i] = 0.f;
  const uint32_t k_lane = smem_u32(k_t + b_row() * L::kLdK + b_col());
#pragma unroll
  for (int kk = 0; kk < kFwdKeys / 16; ++kk)
#pragma unroll
    for (int ks = 0; ks < DKP / 16; ++ks) {
      uint32_t b[4];
      ldsm_x4(b, k_lane + 2 * (kk * 16 * L::kLdK + ks * 16));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(s[mt][2 * kk], qa[mt][ks], b[0], b[1]);
        mma_bf16(s[mt][2 * kk + 1], qa[mt][ks], b[2], b[3]);
      }
    }
  if (MASK) {
    const int key0 = j0 + 2 * (threadIdx.x & 3);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (key0 + n * 8 + (i & 1) >= S) s[mt][n][i] = -INFINITY;
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    // row max and row sum over the lane's 2 * NS values of each row, in 4
    // interleaved partials per row: short dependency chains
    float mx[2][4], sum[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mx[r][j] = -INFINITY;
        sum[r][j] = 0.f;
      }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mx[i >> 1][n & 3] = fmaxf(mx[i >> 1][n & 3], s[mt][n][i]);
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float x = fmaxf(fmaxf(mx[r][0], mx[r][1]),
                            fmaxf(mx[r][2], mx[r][3]));
      const float m_new = fmaxf(m[mt][r], row_max(x) * c);
      corr[r] = ex2(m[mt][r] - m_new);
      m[mt][r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[mt][n][i] = ex2(fmaf(s[mt][n][i], c, -m[mt][i >> 1]));
        sum[i >> 1][n & 3] += s[mt][n][i];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l[mt][r] = l[mt][r] * corr[r]
                 + ((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
#pragma unroll
    for (int n = 0; n < DVP / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][n][i] *= corr[i >> 1];
  }
  const uint32_t v_lane = smem_u32(v_t + a_row() * L::kLdV + a_col());
#pragma unroll
  for (int kk = 0; kk < kFwdKeys / 16; ++kk) {
    uint32_t pa[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      pa[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
      pa[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
      pa[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
      pa[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
    }
#pragma unroll
    for (int nv = 0; nv < DVP / 16; ++nv) {
      uint32_t b[4];
      ldsm_x4_t(b, v_lane + 2 * (kk * 16 * L::kLdV + nv * 16));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[mt][2 * nv], pa[mt], b[0], b[1]);
        mma_bf16(acc[mt][2 * nv + 1], pa[mt], b[2], b[3]);
      }
    }
  }
}

// c = scale * log2(e); vec: the 16-byte load path (see load_tile)
template <int DKP, int DVP>
__global__ void __launch_bounds__(
    kFwdThreads,
    (MinBlocks<DKP, DVP, kFwdWarps, FwdLayout<DKP, DVP>::kMT>::value))
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int S, int dk, int dv, float c,
                 int vec) {
  using L = FwdLayout<DKP, DVP>;
  constexpr int NO = DVP / 8, MT = L::kMT;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [kRowsCta][kLdK]
  bf16* kv_s = q_s + L::kRowsCta * L::kLdK;   // 2 x (k [kFwdKeys][kLdK],
                                              //      v [kFwdKeys][kLdV])
  const int b = blockIdx.y, q0 = blockIdx.x * L::kRowsCta;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bf16* kb = k + (int64_t)b * S * dk;
  const bf16* vb = v + (int64_t)b * S * dv;
  const int tiles = (S + kFwdKeys - 1) / kFwdKeys;
  auto load_kv = [&](int t) {
    bf16* k_t = kv_s + (t & 1) * L::kStage;
    load_tile<kFwdKeys, DKP, kFwdThreads>(k_t, L::kLdK, kb, t * kFwdKeys, S,
                                          dk, vec);
    load_tile<kFwdKeys, DVP, kFwdThreads>(k_t + kFwdKeys * L::kLdK, L::kLdV,
                                          vb, t * kFwdKeys, S, dv, vec);
    cp_async_commit();
  };

  load_tile<L::kRowsCta, DKP, kFwdThreads>(
      q_s, L::kLdK, q + (int64_t)b * S * dk, q0, S, dk, vec);
  load_kv(0);
  cp_async_wait_all();
  __syncthreads();
  // this warp's q rows as A fragments for the whole walk; a negative scale
  // goes into them as a sign flip (exact), so that c > 0 below
  uint32_t qa[MT][DKP / 16][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int ks = 0; ks < DKP / 16; ++ks)
      ldsm_x4(qa[mt][ks],
              smem_u32(q_s + ((warp * MT + mt) * kRows + a_row()) * L::kLdK
                       + ks * 16 + a_col()));
  if (c < 0.f) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int ks = 0; ks < DKP / 16; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[mt][ks][i] ^= 0x80008000u;
    c = -c;
  }

  float acc[MT][NO][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][n][i] = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = kNegInf;
      l[mt][r] = 0.f;
    }
  }
  for (int t = 0; t < tiles; ++t) {
    if (t > 0) {
      cp_async_wait_all();  // tile t is in; every warp is done with t - 1
      __syncthreads();
    }
    if (t + 1 < tiles) load_kv(t + 1);
    const bf16* k_t = kv_s + (t & 1) * L::kStage;
    const bf16* v_t = k_t + kFwdKeys * L::kLdK;
    const int j0 = t * kFwdKeys;
    if (j0 + kFwdKeys > S)
      fwd_tile<DKP, DVP, true>(qa, k_t, v_t, j0, S, c, acc, m, l);
    else
      fwd_tile<DKP, DVP, false>(qa, k_t, v_t, j0, S, c, acc, m, l);
  }

  const int t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int row0 = q0 + (warp * MT + mt) * kRows + (lane >> 2);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[mt][r] = row_sum(l[mt][r]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= S) continue;
      float* o = out + ((int64_t)b * S + row) * dv;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        store_pair(o, n * 8 + 2 * t4, dv, acc[mt][n][2 * r] / l[mt][r],
                   acc[mt][n][2 * r + 1] / l[mt][r]);
      if (t4 == 0)
        lse[(int64_t)b * S + row] = (m[mt][r] + log2f(l[mt][r])) * kLn2;
    }
  }
}

template <int DKP, int DVP>
struct DkvLayout {
  static constexpr int kMT = mtiles<DKP, DVP, kDkvMTiles>();
  static constexpr int kKeysCta = kDkvWarps * kMT * kRows;  // keys
  static constexpr int kLdK = DKP + kPadH, kLdV = DVP + kPadH;
  static constexpr int kStage = kDkvRows * (kLdK + kLdV);  // q, do elements
  // lse * log2(e) and delta for 2 stages, then k, v, then the q, do stages
  static constexpr int kStats = 4 * kDkvRows;
  static constexpr int kBytes =
      4 * kStats + 2 * (kKeysCta * (kLdK + kLdV) + 2 * kStage);
};

// One warp's kMT x 16 keys against one q tile, 16 q rows at a time:
// s^T = k . q^T, dp^T = v . do^T, p = ex2(s * c - lse2),
// ds = p * (dp - delta), then dv += bf16(p^T) . do and dk += bf16(ds^T) . q
// with p and ds packed into A fragments in registers; each q and do
// fragment loaded once serves every m tile; dk's n8 tiles past d_qk are
// skipped.
template <int DKP, int DVP, int MT>
__device__ __forceinline__ void dkv_tile(
    const uint32_t (&ka)[MT][DKP / 16][4],
    const uint32_t (&va)[MT][DVP / 16][4], const bf16* q_t,
    const bf16* do_t, const float* lse2_t, const float* delta_t, float c,
    int dk, float (&dk_acc)[MT][DKP / 8][4],
    float (&dv_acc)[MT][DVP / 8][4]) {
  using L = DkvLayout<DKP, DVP>;
  const int t2 = 2 * (threadIdx.x & 3);
  const uint32_t q_b = smem_u32(q_t + b_row() * L::kLdK + b_col());
  const uint32_t do_b = smem_u32(do_t + b_row() * L::kLdV + b_col());
  const uint32_t q_a = smem_u32(q_t + a_row() * L::kLdK + a_col());
  const uint32_t do_a = smem_u32(do_t + a_row() * L::kLdV + a_col());
#pragma unroll
  for (int jj = 0; jj < kDkvRows / 16; ++jj) {
    float s[MT][2][4], dp[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[mt][n][i] = dp[mt][n][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DKP / 16; ++ks) {
      uint32_t b[4];
      ldsm_x4(b, q_b + 2 * (jj * 16 * L::kLdK + ks * 16));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(s[mt][0], ka[mt][ks], b[0], b[1]);
        mma_bf16(s[mt][1], ka[mt][ks], b[2], b[3]);
      }
    }
#pragma unroll
    for (int ks = 0; ks < DVP / 16; ++ks) {
      uint32_t b[4];
      ldsm_x4(b, do_b + 2 * (jj * 16 * L::kLdV + ks * 16));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(dp[mt][0], va[mt][ks], b[0], b[1]);
        mma_bf16(dp[mt][1], va[mt][ks], b[2], b[3]);
      }
    }
    uint32_t pa[MT][4], da[MT][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int col = jj * 16 + n * 8 + t2;
      const float2 ls = *reinterpret_cast<const float2*>(lse2_t + col);
      const float2 de = *reinterpret_cast<const float2*>(delta_t + col);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float p0 = ex2(fmaf(s[mt][n][0], c, -ls.x));
        const float p1 = ex2(fmaf(s[mt][n][1], c, -ls.y));
        const float p2 = ex2(fmaf(s[mt][n][2], c, -ls.x));
        const float p3 = ex2(fmaf(s[mt][n][3], c, -ls.y));
        pa[mt][2 * n] = pack_bf16(p0, p1);
        pa[mt][2 * n + 1] = pack_bf16(p2, p3);
        da[mt][2 * n] = pack_bf16(p0 * (dp[mt][n][0] - de.x),
                                  p1 * (dp[mt][n][1] - de.y));
        da[mt][2 * n + 1] = pack_bf16(p2 * (dp[mt][n][2] - de.x),
                                      p3 * (dp[mt][n][3] - de.y));
      }
    }
#pragma unroll
    for (int nv = 0; nv < DVP / 16; ++nv) {
      uint32_t b[4];
      ldsm_x4_t(b, do_a + 2 * (jj * 16 * L::kLdV + nv * 16));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(dv_acc[mt][2 * nv], pa[mt], b[0], b[1]);
        mma_bf16(dv_acc[mt][2 * nv + 1], pa[mt], b[2], b[3]);
      }
    }
#pragma unroll
    for (int nk = 0; nk < DKP / 16; ++nk) {
      const uint32_t addr = q_a + 2 * (jj * 16 * L::kLdK + nk * 16);
      if (nk * 16 + 8 < dk) {
        uint32_t b[4];
        ldsm_x4_t(b, addr);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(dk_acc[mt][2 * nk], da[mt], b[0], b[1]);
          mma_bf16(dk_acc[mt][2 * nk + 1], da[mt], b[2], b[3]);
        }
      } else if (nk * 16 < dk) {
        uint32_t b[2];
        ldsm_x2_t(b, addr);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_bf16(dk_acc[mt][2 * nk], da[mt], b[0], b[1]);
      }
    }
  }
}

// vec: the 16-byte load path (see load_tile). OutT: the gradients'
// dtype, bf16 or float (the f32 accumulators written as they are, for the
// ring backward's cross-hop sums)
template <int DKP, int DVP, typename OutT>
__global__ void __launch_bounds__(
    kDkvThreads,
    (MinBlocks<DKP, DVP, kDkvWarps, DkvLayout<DKP, DVP>::kMT>::value))
flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, OutT* __restrict__ dk_out,
                 OutT* __restrict__ dv_out, int S, int dk, int dv,
                 float scale, int vec) {
  using L = DkvLayout<DKP, DVP>;
  constexpr int NK = DKP / 8, NV = DVP / 8, MT = L::kMT;
  extern __shared__ __align__(16) unsigned char smem[];
  float* stats = reinterpret_cast<float*>(smem);  // 2 x (lse2, delta)
  bf16* k_s = reinterpret_cast<bf16*>(stats + L::kStats);  // [kKeysCta][kLdK]
  bf16* v_s = k_s + L::kKeysCta * L::kLdK;                 // [kKeysCta][kLdV]
  bf16* qd_s = v_s + L::kKeysCta * L::kLdV;  // 2 x (q [kDkvRows][kLdK],
                                             //      do [kDkvRows][kLdV])
  const int b = blockIdx.y, j0 = blockIdx.x * L::kKeysCta;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bf16* qb = q + (int64_t)b * S * dk;
  const bf16* dob = dout + (int64_t)b * S * dv;
  const float* lse_b = lse + (int64_t)b * S;
  const float* delta_b = delta + (int64_t)b * S;
  const float c = scale * kLog2e;
  const int tiles = (S + kDkvRows - 1) / kDkvRows;
  auto load_qdo = [&](int t) {
    bf16* q_t = qd_s + (t & 1) * L::kStage;
    load_tile<kDkvRows, DKP, kDkvThreads>(q_t, L::kLdK, qb, t * kDkvRows, S,
                                          dk, vec);
    load_tile<kDkvRows, DVP, kDkvThreads>(q_t + kDkvRows * L::kLdK, L::kLdV,
                                          dob, t * kDkvRows, S, dv, vec);
    cp_async_commit();
  };
  // lse in log2 units and delta of q row t * kDkvRows + threadIdx.x; rows
  // past S take lse = +inf (p = 0) and delta = 0
  float lse2 = 0.f, dlt = 0.f;
  auto read_stats = [&](int t) {
    const int row = t * kDkvRows + threadIdx.x;
    lse2 = row < S ? lse_b[row] * kLog2e : INFINITY;
    dlt = row < S ? delta_b[row] : 0.f;
  };
  auto write_stats = [&](int t) {
    float* st = stats + (t & 1) * 2 * kDkvRows;
    st[threadIdx.x] = lse2;
    st[kDkvRows + threadIdx.x] = dlt;
  };

  load_tile<L::kKeysCta, DKP, kDkvThreads>(
      k_s, L::kLdK, k + (int64_t)b * S * dk, j0, S, dk, vec);
  load_tile<L::kKeysCta, DVP, kDkvThreads>(
      v_s, L::kLdV, v + (int64_t)b * S * dv, j0, S, dv, vec);
  load_qdo(0);
  if (threadIdx.x < kDkvRows) {
    read_stats(0);
    write_stats(0);
  }
  cp_async_wait_all();
  __syncthreads();
  // this warp's keys of k and v as A fragments for the whole walk
  uint32_t ka[MT][DKP / 16][4], va[MT][DVP / 16][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int row = (warp * MT + mt) * kRows + a_row();
#pragma unroll
    for (int ks = 0; ks < DKP / 16; ++ks)
      ldsm_x4(ka[mt][ks], smem_u32(k_s + row * L::kLdK + ks * 16 + a_col()));
#pragma unroll
    for (int ks = 0; ks < DVP / 16; ++ks)
      ldsm_x4(va[mt][ks], smem_u32(v_s + row * L::kLdV + ks * 16 + a_col()));
  }

  float dk_acc[MT][NK][4], dv_acc[MT][NV][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) dk_acc[mt][n][i] = 0.f;
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) dv_acc[mt][n][i] = 0.f;
  }
  for (int t = 0; t < tiles; ++t) {
    if (t > 0) {
      cp_async_wait_all();  // tile t is in; every warp is done with t - 1
      __syncthreads();
    }
    const bool next = t + 1 < tiles;
    if (next) {
      load_qdo(t + 1);
      if (threadIdx.x < kDkvRows) read_stats(t + 1);
    }
    const bf16* q_t = qd_s + (t & 1) * L::kStage;
    const float* st = stats + (t & 1) * 2 * kDkvRows;
    dkv_tile<DKP, DVP>(ka, va, q_t, q_t + kDkvRows * L::kLdK, st,
                       st + kDkvRows, c, dk, dk_acc, dv_acc);
    // the stage of tile t + 1 was last read in tile t - 1
    if (next && threadIdx.x < kDkvRows) write_stats(t + 1);
  }

  const int t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int row0 = j0 + (warp * MT + mt) * kRows + (lane >> 2);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = row0 + 8 * r;
      if (key >= S) continue;
      OutT* dk_row = dk_out + ((int64_t)b * S + key) * dk;
      OutT* dv_row = dv_out + ((int64_t)b * S + key) * dv;
#pragma unroll
      for (int n = 0; n < NK; ++n)
        store_pair(dk_row, n * 8 + 2 * t4, dk, dk_acc[mt][n][2 * r] * scale,
                   dk_acc[mt][n][2 * r + 1] * scale);
#pragma unroll
      for (int n = 0; n < NV; ++n)
        store_pair(dv_row, n * 8 + 2 * t4, dv, dv_acc[mt][n][2 * r],
                   dv_acc[mt][n][2 * r + 1]);
    }
  }
}

template <int DKP, int DVP>
struct DqLayout {
  static constexpr int kMT = mtiles<DKP, DVP, kDqMTiles>();
  static constexpr int kRowsCta = kDqWarps * kMT * kRows;  // q rows
  static constexpr int kLdK = DKP + kPadH, kLdV = DVP + kPadH;
  static constexpr int kStage = kDqKeys * (kLdK + kLdV);  // k, v elements
  static constexpr int kBytes =
      2 * (kRowsCta * (kLdK + kLdV) + 2 * kStage);
};

// One warp's kMT x 16 q rows against one key tile, 16 keys at a time:
// s = q . k^T and dp = do . v^T (k and v read with ldmatrix),
// p = ex2(s * c - lse2), ds = p * (dp - delta) packed into the A fragment
// of dq += bf16(ds) . k (the same k tile read with ldmatrix.trans), over
// only the n8 tiles d_qk needs; each k or v fragment serves every m tile.
// MASK: keys past S get p = 0 (their k and v rows are zero-filled, but
// ex2(-lse2) alone could overflow).
template <int DKP, int DVP, bool MASK, int MT>
__device__ __forceinline__ void dq_tile(
    const uint32_t (&qa)[MT][DKP / 16][4],
    const uint32_t (&doa)[MT][DVP / 16][4], const bf16* k_t,
    const bf16* v_t, int j0, int S, float c, int dk,
    const float (&lse2)[MT][2], const float (&dlt)[MT][2],
    float (&acc)[MT][DKP / 8][4]) {
  using L = DqLayout<DKP, DVP>;
  const int t2 = 2 * (threadIdx.x & 3);
  const uint32_t k_b = smem_u32(k_t + b_row() * L::kLdK + b_col());
  const uint32_t v_b = smem_u32(v_t + b_row() * L::kLdV + b_col());
  const uint32_t k_a = smem_u32(k_t + a_row() * L::kLdK + a_col());
#pragma unroll
  for (int kk = 0; kk < kDqKeys / 16; ++kk) {
    float s[MT][2][4], dp[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[mt][n][i] = dp[mt][n][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DKP / 16; ++ks) {
      uint32_t b[4];
      ldsm_x4(b, k_b + 2 * (kk * 16 * L::kLdK + ks * 16));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(s[mt][0], qa[mt][ks], b[0], b[1]);
        mma_bf16(s[mt][1], qa[mt][ks], b[2], b[3]);
      }
    }
#pragma unroll
    for (int ks = 0; ks < DVP / 16; ++ks) {
      uint32_t b[4];
      ldsm_x4(b, v_b + 2 * (kk * 16 * L::kLdV + ks * 16));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(dp[mt][0], doa[mt][ks], b[0], b[1]);
        mma_bf16(dp[mt][1], doa[mt][ks], b[2], b[3]);
      }
    }
    uint32_t da[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float p = ex2(fmaf(s[mt][n][i], c, -lse2[mt][i >> 1]));
          if (MASK && j0 + kk * 16 + n * 8 + t2 + (i & 1) >= S) p = 0.f;
          x[i] = p * (dp[mt][n][i] - dlt[mt][i >> 1]);
        }
        da[mt][2 * n] = pack_bf16(x[0], x[1]);
        da[mt][2 * n + 1] = pack_bf16(x[2], x[3]);
      }
#pragma unroll
    for (int nk = 0; nk < DKP / 16; ++nk) {
      const uint32_t addr = k_a + 2 * (kk * 16 * L::kLdK + nk * 16);
      if (nk * 16 + 8 < dk) {
        uint32_t b[4];
        ldsm_x4_t(b, addr);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * nk], da[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * nk + 1], da[mt], b[2], b[3]);
        }
      } else if (nk * 16 < dk) {
        uint32_t b[2];
        ldsm_x2_t(b, addr);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_bf16(acc[mt][2 * nk], da[mt], b[0], b[1]);
      }
    }
  }
}

// vec: the 16-byte load path (see load_tile); OutT as in flash_dkv_kernel
template <int DKP, int DVP, typename OutT>
__global__ void __launch_bounds__(
    kDqThreads,
    (MinBlocks<DKP, DVP, kDqWarps, DqLayout<DKP, DVP>::kMT>::value))
flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, OutT* __restrict__ dq,
                int S, int dk, int dv, float scale, int vec) {
  using L = DqLayout<DKP, DVP>;
  constexpr int MT = L::kMT;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [kRowsCta][kLdK]
  bf16* do_s = q_s + L::kRowsCta * L::kLdK;   // [kRowsCta][kLdV]
  bf16* kv_s = do_s + L::kRowsCta * L::kLdV;  // 2 x (k [kDqKeys][kLdK],
                                              //      v [kDqKeys][kLdV])
  const int b = blockIdx.y, q0 = blockIdx.x * L::kRowsCta;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bf16* kb = k + (int64_t)b * S * dk;
  const bf16* vb = v + (int64_t)b * S * dv;
  const int tiles = (S + kDqKeys - 1) / kDqKeys;
  auto load_kv = [&](int t) {
    bf16* k_t = kv_s + (t & 1) * L::kStage;
    load_tile<kDqKeys, DKP, kDqThreads>(k_t, L::kLdK, kb, t * kDqKeys, S,
                                        dk, vec);
    load_tile<kDqKeys, DVP, kDqThreads>(k_t + kDqKeys * L::kLdK, L::kLdV,
                                        vb, t * kDqKeys, S, dv, vec);
    cp_async_commit();
  };

  load_tile<L::kRowsCta, DKP, kDqThreads>(
      q_s, L::kLdK, q + (int64_t)b * S * dk, q0, S, dk, vec);
  load_tile<L::kRowsCta, DVP, kDqThreads>(
      do_s, L::kLdV, dout + (int64_t)b * S * dv, q0, S, dv, vec);
  load_kv(0);
  // lse in log2 units and delta of this lane's rows, read while the tiles
  // load; rows past S take lse = +inf (p = 0) and delta = 0
  float lse2[MT][2], dlt[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + (warp * MT + mt) * kRows + (lane >> 2) + 8 * r;
      lse2[mt][r] = row < S ? lse[(int64_t)b * S + row] * kLog2e : INFINITY;
      dlt[mt][r] = row < S ? delta[(int64_t)b * S + row] : 0.f;
    }
  cp_async_wait_all();
  __syncthreads();
  // this warp's q and do rows as A fragments for the whole walk
  uint32_t qa[MT][DKP / 16][4], doa[MT][DVP / 16][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int row = (warp * MT + mt) * kRows + a_row();
#pragma unroll
    for (int ks = 0; ks < DKP / 16; ++ks)
      ldsm_x4(qa[mt][ks], smem_u32(q_s + row * L::kLdK + ks * 16 + a_col()));
#pragma unroll
    for (int ks = 0; ks < DVP / 16; ++ks)
      ldsm_x4(doa[mt][ks],
              smem_u32(do_s + row * L::kLdV + ks * 16 + a_col()));
  }

  float acc[MT][DKP / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < DKP / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][n][i] = 0.f;
  const float c = scale * kLog2e;
  for (int t = 0; t < tiles; ++t) {
    if (t > 0) {
      cp_async_wait_all();  // tile t is in; every warp is done with t - 1
      __syncthreads();
    }
    if (t + 1 < tiles) load_kv(t + 1);
    const bf16* k_t = kv_s + (t & 1) * L::kStage;
    const bf16* v_t = k_t + kDqKeys * L::kLdK;
    const int j0 = t * kDqKeys;
    if (j0 + kDqKeys > S)
      dq_tile<DKP, DVP, true>(qa, doa, k_t, v_t, j0, S, c, dk, lse2, dlt,
                              acc);
    else
      dq_tile<DKP, DVP, false>(qa, doa, k_t, v_t, j0, S, c, dk, lse2, dlt,
                               acc);
  }

  const int t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int row0 = q0 + (warp * MT + mt) * kRows + (lane >> 2);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= S) continue;
      OutT* o = dq + ((int64_t)b * S + row) * dk;
#pragma unroll
      for (int n = 0; n < DKP / 8; ++n)
        store_pair(o, n * 8 + 2 * t4, dk, acc[mt][n][2 * r] * scale,
                   acc[mt][n][2 * r + 1] * scale);
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
  int out_dtype;  // dq, dk, dv: the operands' dtype code, or kFloat32
};

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

using dcgan::aligned16;

// bf16 dq or dkv writing OutT gradients
template <int DKP, int DVP, typename OutT>
cudaError_t launch_bf16_bwd(Which which, const Args& a, int vec) {
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* d = static_cast<const bf16*>(a.dout);
  cudaError_t err;
  if (which == kDq) {
    const int bytes = DqLayout<DKP, DVP>::kBytes;
    if ((err = prepare(flash_dq_kernel<DKP, DVP, OutT>, bytes))) return err;
    constexpr int rows = DqLayout<DKP, DVP>::kRowsCta;
    const dim3 grid((a.s + rows - 1) / rows, a.b);
    flash_dq_kernel<DKP, DVP, OutT><<<grid, kDqThreads, bytes, a.stream>>>(
        q, k, v, d, a.lse, a.delta, static_cast<OutT*>(a.out0), a.s, a.dk,
        a.dv, a.scale, vec);
  } else {
    const int bytes = DkvLayout<DKP, DVP>::kBytes;
    if ((err = prepare(flash_dkv_kernel<DKP, DVP, OutT>, bytes))) return err;
    constexpr int keys = DkvLayout<DKP, DVP>::kKeysCta;
    const dim3 grid((a.s + keys - 1) / keys, a.b);
    flash_dkv_kernel<DKP, DVP, OutT><<<grid, kDkvThreads, bytes, a.stream>>>(
        q, k, v, d, a.lse, a.delta, static_cast<OutT*>(a.out0),
        static_cast<OutT*>(a.out1), a.s, a.dk, a.dv, a.scale, vec);
  }
  return cudaGetLastError();
}

// bf16 forward, dq and dkv
template <int DKP, int DVP>
cudaError_t launch_bf16(Which which, const Args& a) {
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  // 16-byte rows and pointers take cp.async, anything else scalar loads
  const int vec = a.dk % 8 == 0 && a.dv % 8 == 0 && aligned16(q)
                  && aligned16(k) && aligned16(v)
                  && (which == kFwd || aligned16(a.dout));
  cudaError_t err;
  if (which == kFwd) {
    const int bytes = FwdLayout<DKP, DVP>::kBytes;
    if ((err = prepare(flash_fwd_kernel<DKP, DVP>, bytes))) return err;
    constexpr int rows = FwdLayout<DKP, DVP>::kRowsCta;
    const dim3 grid((a.s + rows - 1) / rows, a.b);
    flash_fwd_kernel<DKP, DVP><<<grid, kFwdThreads, bytes, a.stream>>>(
        q, k, v, static_cast<float*>(a.out0), static_cast<float*>(a.out1),
        a.s, a.dk, a.dv, a.scale * kLog2e, vec);
  } else if (a.out_dtype == dcgan::kFloat32) {
    return launch_bf16_bwd<DKP, DVP, float>(which, a, vec);
  } else {
    return launch_bf16_bwd<DKP, DVP, bf16>(which, a, vec);
  }
  return cudaGetLastError();
}

// f32 forward, dq and dkv
template <int DKP, int DVP>
cudaError_t launch_f32(Which which, const Args& a) {
  const dim3 grid((a.s + kTile - 1) / kTile, a.b);
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* d = static_cast<const float*>(a.dout);
  cudaError_t err;
  if (which == kFwd) {
    const int bytes = FwdSmem<DKP, DVP>::kBytes;
    if ((err = prepare(flash_fwd_simt_kernel<DKP, DVP>, bytes))) return err;
    flash_fwd_simt_kernel<DKP, DVP><<<grid, kThreads, bytes, a.stream>>>(
        q, k, v, static_cast<float*>(a.out0), static_cast<float*>(a.out1),
        a.s, a.dk, a.dv, a.scale);
  } else if (which == kDq) {
    const int bytes = DqSmem<DKP, DVP>::kBytes;
    if ((err = prepare(flash_dq_simt_kernel<DKP, DVP>, bytes))) return err;
    flash_dq_simt_kernel<DKP, DVP><<<grid, kThreads, bytes, a.stream>>>(
        q, k, v, d, a.lse, a.delta, static_cast<float*>(a.out0), a.s, a.dk,
        a.dv, a.scale);
  } else {
    const int bytes = DkvSmem<DKP, DVP>::kBytes;
    if ((err = prepare(flash_dkv_simt_kernel<DKP, DVP>, bytes))) return err;
    flash_dkv_simt_kernel<DKP, DVP><<<grid, kThreads, bytes, a.stream>>>(
        q, k, v, d, a.lse, a.delta, static_cast<float*>(a.out0),
        static_cast<float*>(a.out1), a.s, a.dk, a.dv, a.scale);
  }
  return cudaGetLastError();
}

template <typename T, int DKP, int DVP>
cudaError_t launch(Which which, const Args& a) {
  if constexpr (std::is_same<T, bf16>::value)
    return launch_bf16<DKP, DVP>(which, a);
  else
    return launch_f32<DKP, DVP>(which, a);
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
  // gradients in the operands' dtype, or f32 from bf16 operands
  if (a.out_dtype != dtype && a.out_dtype != dcgan::kFloat32)
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
               scale, static_cast<cudaStream_t>(stream), dtype};
  return run(kFwd, a, dtype);
}

// dq [b, s, dk] in out_dtype: the inputs' dtype, or 0 (float32) from
// bfloat16 inputs
extern "C" int dcgan_flash_dq(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dq, int b, int s,
                              int dk, int dv, int dtype, int out_dtype,
                              float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, b, s, dk, dv, scale,
               static_cast<cudaStream_t>(stream), out_dtype};
  return run(kDq, a, dtype);
}

// dk [b, s, dk] and dv [b, s, dv] in out_dtype, as dcgan_flash_dq
extern "C" int dcgan_flash_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, void* dk_out,
                               void* dv_out, int b, int s, int dk, int dv,
                               int dtype, int out_dtype, float scale,
                               void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk_out, dv_out, b, s, dk, dv,
               scale, static_cast<cudaStream_t>(stream), out_dtype};
  return run(kDkv, a, dtype);
}

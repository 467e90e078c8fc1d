// The Hopper GEMM main loop of gemm_bias_scale_act.cu's bf16 kernel
// (design v2): one CTA sums the product of a kBM x K strip of P [M, K]
// and a K x BN strip of W [K, C] (both bf16, row-major) over a range of
// 64-deep K blocks into f32 registers, with the tensor memory accelerator
// (TMA) loading the tiles and wgmma multiplying them.
//
//   TMA: P tiles are boxes of 64 K (128 bytes) by kBM rows, K-major; W
//   tiles are BN / 64 boxes of 64 columns by 64 K rows, MN-major (W is
//   read as it lies, never transposed). Both land 128-byte-swizzled in
//   1024-byte-aligned shared stages; out-of-range rows, columns and K
//   fill with zeros, so ragged edges need no masking in the loop.
//   Pipeline: a ring of stages, each with a "full" mbarrier (the
//   producer's expect-tx, completed by the TMA's bytes) and an "empty" one
//   (one arrival per consumer warpgroup once its wgmma has read the
//   stage).
//   Warp specialisation: kBM / 64 consumer warpgroups, each owning 64 rows
//   of the tile, then one producer warp whose first lane issues every TMA.
//   Products: wgmma.mma_async m64nBNk16 bf16 -> f32, A and B both read
//   through shared-memory descriptors (B with the transpose bit, being
//   MN-major); one wgmma group stays in flight while the next stage is
//   awaited, and the stage before it is released.
//   The N tile is all of C up to 256 (BN = 64, 128 or 256), so each row of
//   P is read from HBM once.
// The accumulator lands in the wgmma fragment layout: thread t of a
// warpgroup holds, for n8 tile j, d[4j], d[4j + 1] at row 16 (t / 32) +
// (t % 32) / 4, columns 8j + 2 (t % 4) + {0, 1}, and d[4j + 2], d[4j + 3]
// eight rows below.
//
// Inline PTX, no CUTLASS: the build stays one nvcc call of seconds.
#pragma once

#include <cstdint>

#include <cuda.h>  // CUtensorMap and the driver's enums (types only)
#include <cuda_runtime.h>

namespace dcgan {
namespace wgmma_gemm {

// Tile constants, chosen on the card by a tile sweep (PERF.md). The launch
// plan (ops/fused.py::gbsa_plan) carries the same numbers and the launch
// checks them.
constexpr int kBM = 128;        // rows per CTA: kBM / 64 consumer warpgroups
constexpr int kMaxStages = 6;   // ring depth, where the shared memory allows
constexpr int kBK = 64;         // K per stage: one 128-byte swizzle row
constexpr int kSmemBudget = 200 * 1024;  // bytes of ring per CTA at most
// a barrier wait that outlasts this many cycles (~8 s) traps: a lost TMA
// fails the launch instead of hanging the card
constexpr long long kWaitCycles = 1ll << 34;

template <int BN>
struct WgmmaTile {
  static_assert(BN == 64 || BN == 128 || BN == 256, "wgmma N tile");
  static constexpr int kConsumers = kBM / 64;
  static constexpr int kThreads = kConsumers * 128 + 32;
  static constexpr int kABytes = kBM * kBK * 2;   // a P stage
  static constexpr int kBBytes = kBK * BN * 2;    // a W stage
  static constexpr int kStageBytes = kABytes + kBBytes;
  // two CTAs per SM for the narrow tile (its epilogue and ring fill
  // overlap the other CTA's loop), one for the wider ones
  static constexpr int kMinBlocks = BN == 64 ? 2 : 1;
  // the ring as deep as kMaxStages and the CTA's share of kSmemBudget
  // allow: 4 stages at BN 64 and 256, 6 at BN 128
  static constexpr int kFit = kSmemBudget / kMinBlocks / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  // the ring, its barriers, and slack to align the ring to 1024 bytes
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes
                                    + 2 * kStages * 8;
  static constexpr int kAcc = BN / 2;   // f32 accumulators per thread
  static_assert(kStages >= 2, "the ring needs two stages");
};

// Output column tile for C: all of C up to 256, in wgmma's widths
inline int tile_n(int c) { return c <= 64 ? 64 : c <= 128 ? 128 : 256; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar,
                                              uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

// Wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > kWaitCycles) __trap();
}

// One TMA box at coordinates (c0 innermost, c1) into shared memory at dst,
// completing `bytes` on the barrier
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1
// (128-byte swizzle). K-major A: lbo unused, sbo = 1024 (8 rows of 128
// bytes). MN-major B: lbo = the distance between 64-column boxes, sbo =
// 1024 (8 K rows of 128 bytes).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | (uint64_t)((lbo >> 4) & 0x3FFF) << 16
         | (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t a,
                                      uint64_t b);

// d[64 x 64] += A[64 x 16] . B[16 x 64]: A K-major, B MN-major, both
// through 128-byte-swizzled shared-memory descriptors
template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], uint64_t a,
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d[64 x 128] += A[64 x 16] . B[16 x 128]: A K-major, B MN-major, both
// through 128-byte-swizzled shared-memory descriptors
template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], uint64_t a,
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// d[64 x 256] += A[64 x 16] . B[16 x 256]: A K-major, B MN-major, both
// through 128-byte-swizzled shared-memory descriptors
template <>
__device__ __forceinline__ void wgmma<256>(float (&d)[128], uint64_t a,
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// acc = P[m0 : m0 + kBM, K blocks kb_begin .. kb_end) . W[same K,
// n0 : n0 + BN] for this thread's rows (see the header). Call with every
// thread of a WgmmaTile<BN>::kThreads block; `smem` is the block's dynamic
// shared memory of WgmmaTile<BN>::kSmemBytes. Returns false on the
// producer warp, which has nothing left to do, true on the consumers.
template <int BN>
__device__ __forceinline__ bool wgmma_tile_product(
    const CUtensorMap& map_p, const CUtensorMap& map_w, unsigned char* smem,
    int m0, int n0, int kb_begin, int kb_end, float (&acc)[BN / 2]) {
  using T = WgmmaTile<BN>;
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t a_s = base;
  const uint32_t b_s = a_s + T::kStages * T::kABytes;
  const uint32_t full = b_s + T::kStages * T::kBBytes;  // kStages barriers
  const uint32_t empty = full + 8 * T::kStages;         // kStages barriers
  const int warp = threadIdx.x / 32;
  const int n_kb = kb_end > kb_begin ? kb_end - kb_begin : 0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, T::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * T::kConsumers) {  // the producer warp
    if (threadIdx.x % 32 == 0) {
      for (int i = 0; i < n_kb; ++i) {
        const int s = i % T::kStages;
        // a fresh barrier counts its phase of parity 1 as complete, so
        // the first pass over the ring does not wait
        mbar_wait(empty + 8 * s, ((i / T::kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, T::kStageBytes);
        const int k0 = (kb_begin + i) * kBK;
        tma_load_2d(a_s + s * T::kABytes, &map_p, k0, m0, full + 8 * s);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(b_s + s * T::kBBytes + j * kBK * 128, &map_w,
                      n0 + 64 * j, k0, full + 8 * s);
      }
    }
    return false;
  }

#pragma unroll
  for (int i = 0; i < T::kAcc; ++i) acc[i] = 0.f;
  const uint32_t a_wg = a_s + (warp / 4) * 64 * 128;  // this group's rows
  for (int i = 0; i < n_kb; ++i) {
    const int s = i % T::kStages;
    mbar_wait(full + 8 * s, (i / T::kStages) & 1);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // K-major A advances 32 bytes per k16 step inside its swizzled
      // rows; MN-major B advances 16 K rows of 128 bytes
      const uint64_t a = smem_desc(a_wg + s * T::kABytes + 32 * kk, 16,
                                   1024);
      const uint64_t b = smem_desc(b_s + s * T::kBBytes + 2048 * kk,
                                   kBK * 128, 1024);
      wgmma<BN>(acc, a, b);
    }
    wgmma_commit();
    fence_acc(acc);
    // the group of block i - 1 is done: its stage can be refilled
    wgmma_wait<1>();
    fence_acc(acc);
    if (i > 0 && threadIdx.x % 128 == 0)
      mbar_arrive(empty + 8 * ((i - 1) % T::kStages));
  }
  wgmma_wait<0>();
  fence_acc(acc);
  return true;
}

// The host side: a 2-D bf16 tensor map over a row-major [rows, cols]
// matrix with boxes of box_cols x box_rows, 128-byte swizzle, zero fill
// out of range. cuTensorMapEncodeTiled comes through the runtime's driver
// entry point, so the library needs no -lcuda. Returns false if the
// driver refuses (or lacks) it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess
        || found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

inline bool bf16_tensor_map(CUtensorMap* map, const void* ptr, int rows,
                            int cols, int box_rows, int box_cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace wgmma_gemm
}  // namespace dcgan

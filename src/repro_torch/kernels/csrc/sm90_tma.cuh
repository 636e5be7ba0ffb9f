// What kernel A's bf16 latent route (flash_fwd_latent_sm90.cu) adds to the
// tensor-core helpers of sm90_common.cuh: `mbarrier`s, 4-d TMA tile loads
// and their tensor maps, the row reductions of an m64nN accumulator, and the
// register-A m64n128k16 product.  (The one-D route, flash_fwd_sm90.cu, keeps
// its own copies of the ones it uses: moving them there changed the rounding
// of its outputs in the last bits.)  The register-A m64n192k16 product
// serves the pair routes (flash_fwd_pair_sm90.cu, flash_bwd_pair_sm90.cu).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace repro_sm90 {

constexpr float kLn2 = 0.6931471805599453f;

// ------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

// Arrives and adds `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// TMA: the box at coordinates (c0, c1, c2, c3) of tensor map `map` into
// shared memory at dst; completes `bytes` of the barrier's transactions.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// Spins until the phase of parity `parity` of the barrier has completed.
// A phase that never completes (a fault in the ring's bookkeeping) traps
// after 2^26 polls, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// ------------------------------------------------- accumulator reductions

// The largest of this thread's N / 2 entries of accumulator row r (entries
// i with (i >> 1) & 1 == r) of an m64nN float32 accumulator, as a tree.
template <int N>
__device__ __forceinline__ float row_max(const float (&s)[N], int r) {
  static_assert(N >= 8 && (N & (N - 1)) == 0, "N a power of two");
  float t[N / 4];
#pragma unroll
  for (int q = 0; q < N / 4; ++q)
    t[q] = fmaxf(s[4 * q + 2 * r], s[4 * q + 2 * r + 1]);
#pragma unroll
  for (int n = N / 8; n >= 1; n /= 2)
#pragma unroll
    for (int q = 0; q < n; ++q) t[q] = fmaxf(t[q], t[q + n]);
  return t[0];
}

// The largest of x over the 4 lanes of a quad (which share a row).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// d (64 × 128, float32, as the two 64-column halves d0 and d1) += A · B, A
// (64 × 16 bf16) in registers, B in shared memory, MN-major (transpose bit
// set) across two 64-column slabs: the leading byte offset is the slab
// stride, the stride byte offset the 1024 bytes between 8-row groups.
__device__ __forceinline__ void mma_rs_n128(float (&d0)[32], float (&d1)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]), "+f"(d0[4]),
        "+f"(d0[5]), "+f"(d0[6]), "+f"(d0[7]), "+f"(d0[8]), "+f"(d0[9]),
        "+f"(d0[10]), "+f"(d0[11]), "+f"(d0[12]), "+f"(d0[13]), "+f"(d0[14]),
        "+f"(d0[15]), "+f"(d0[16]), "+f"(d0[17]), "+f"(d0[18]), "+f"(d0[19]),
        "+f"(d0[20]), "+f"(d0[21]), "+f"(d0[22]), "+f"(d0[23]), "+f"(d0[24]),
        "+f"(d0[25]), "+f"(d0[26]), "+f"(d0[27]), "+f"(d0[28]), "+f"(d0[29]),
        "+f"(d0[30]), "+f"(d0[31]), "+f"(d1[0]), "+f"(d1[1]), "+f"(d1[2]),
        "+f"(d1[3]), "+f"(d1[4]), "+f"(d1[5]), "+f"(d1[6]), "+f"(d1[7]),
        "+f"(d1[8]), "+f"(d1[9]), "+f"(d1[10]), "+f"(d1[11]), "+f"(d1[12]),
        "+f"(d1[13]), "+f"(d1[14]), "+f"(d1[15]), "+f"(d1[16]), "+f"(d1[17]),
        "+f"(d1[18]), "+f"(d1[19]), "+f"(d1[20]), "+f"(d1[21]), "+f"(d1[22]),
        "+f"(d1[23]), "+f"(d1[24]), "+f"(d1[25]), "+f"(d1[26]), "+f"(d1[27]),
        "+f"(d1[28]), "+f"(d1[29]), "+f"(d1[30]), "+f"(d1[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 × 192, float32, as the 64-column thirds d0, d1, d2) += A · B, A
// (64 × 16 bf16) in registers, B in shared memory, MN-major (transpose
// bit set) across three 64-column slabs.
__device__ __forceinline__ void mma_rs_n192(float (&d0)[32], float (&d1)[32],
                                            float (&d2)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
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
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]), "+f"(d0[4]),
        "+f"(d0[5]), "+f"(d0[6]), "+f"(d0[7]), "+f"(d0[8]), "+f"(d0[9]),
        "+f"(d0[10]), "+f"(d0[11]), "+f"(d0[12]), "+f"(d0[13]), "+f"(d0[14]),
        "+f"(d0[15]), "+f"(d0[16]), "+f"(d0[17]), "+f"(d0[18]), "+f"(d0[19]),
        "+f"(d0[20]), "+f"(d0[21]), "+f"(d0[22]), "+f"(d0[23]), "+f"(d0[24]),
        "+f"(d0[25]), "+f"(d0[26]), "+f"(d0[27]), "+f"(d0[28]), "+f"(d0[29]),
        "+f"(d0[30]), "+f"(d0[31]), "+f"(d1[0]), "+f"(d1[1]), "+f"(d1[2]),
        "+f"(d1[3]), "+f"(d1[4]), "+f"(d1[5]), "+f"(d1[6]), "+f"(d1[7]),
        "+f"(d1[8]), "+f"(d1[9]), "+f"(d1[10]), "+f"(d1[11]), "+f"(d1[12]),
        "+f"(d1[13]), "+f"(d1[14]), "+f"(d1[15]), "+f"(d1[16]), "+f"(d1[17]),
        "+f"(d1[18]), "+f"(d1[19]), "+f"(d1[20]), "+f"(d1[21]), "+f"(d1[22]),
        "+f"(d1[23]), "+f"(d1[24]), "+f"(d1[25]), "+f"(d1[26]), "+f"(d1[27]),
        "+f"(d1[28]), "+f"(d1[29]), "+f"(d1[30]), "+f"(d1[31]), "+f"(d2[0]),
        "+f"(d2[1]), "+f"(d2[2]), "+f"(d2[3]), "+f"(d2[4]), "+f"(d2[5]),
        "+f"(d2[6]), "+f"(d2[7]), "+f"(d2[8]), "+f"(d2[9]), "+f"(d2[10]),
        "+f"(d2[11]), "+f"(d2[12]), "+f"(d2[13]), "+f"(d2[14]), "+f"(d2[15]),
        "+f"(d2[16]), "+f"(d2[17]), "+f"(d2[18]), "+f"(d2[19]), "+f"(d2[20]),
        "+f"(d2[21]), "+f"(d2[22]), "+f"(d2[23]), "+f"(d2[24]), "+f"(d2[25]),
        "+f"(d2[26]), "+f"(d2[27]), "+f"(d2[28]), "+f"(d2[29]), "+f"(d2[30]),
        "+f"(d2[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ------------------------------------------------------------ tensor maps

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime (the
// libraries link no libcuda of their own).
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// The TMA map of one (B, T, H, D) bf16 tensor with element strides sb, st,
// sh, as the 4-d tensor (D, H, T, B): boxes of 64 columns × box_h heads ×
// box_t rows × 1, 128-byte swizzled, out-of-bounds elements read as zero.
// A box lands as box_h · box_t rows of 128 bytes, heads inner.  A dimension
// of extent 1 gets a stride that follows from the one before (its own is
// never used).  Returns the CUresult.
inline int tile_map(CUtensorMap* m, const void* base, int D, int H, int T,
                    int B, long long sh, long long st, long long sb,
                    int box_h, int box_t) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(CUDA_ERROR_NOT_FOUND);
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                        static_cast<cuuint64_t>(H),
                        static_cast<cuuint64_t>(T),
                        static_cast<cuuint64_t>(B)};
  const long long el[3] = {sh, st, sb};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = dims[i + 1] > 1 ? static_cast<cuuint64_t>(2 * el[i])
                 : i == 0        ? 2 * dims[0]
                                 : strides[i - 1] * dims[i];
  cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_h),
                       static_cast<cuuint32_t>(box_t), 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  return static_cast<int>(enc(
      m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

}  // namespace repro_sm90

// What the tensor-core (sm_90a) kernels share: kernels C and D's bf16 route
// (flash_bwd_sm90.cu) and kernel A's (flash_fwd_sm90.cu).  PTX wrappers for
// 16-byte `cp.async`, the `wgmma` fence / commit / wait and the m64n64k16
// products, the 128-byte-swizzle shared-memory descriptors, bf16 packing and
// exp2, and the copy of a (B, T, H, D) tile into the swizzled layout.
//
// Tile layout.  A tile of ROWS rows and head dim D is stored bf16 as
// slabs<D>() slabs of ROWS rows × 64 columns (128 bytes a row; D = 32 is
// zero-padded to one slab); 16-byte group g of row r sits at g ^ (r % 8),
// which is what `wgmma` reads through a 128-byte-swizzle descriptor.  Tiles
// start on 1024-byte boundaries.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_sm90 {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;

template <int D>
__host__ __device__ constexpr int slabs() {
  return D < 64 ? 1 : D / 64;
}

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !ok (src is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's generic-proxy writes to shared memory (the cp.async
// copies) visible to the async proxy that wgmma reads operands through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma fence or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A shared-memory matrix descriptor for the 128-byte swizzle: start
// address, leading and stride byte offsets (all >> 4), layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// A tile of ROWS rows as a K-major operand (K = head dim), k16 step ks:
// slab ks / 4, 32 bytes into each 128-byte row per step; 8-row groups 1024
// bytes apart.  As a B operand it is N = ROWS wide.
template <int ROWS>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int ks) {
  return sw128_desc(tile + (ks >> 2) * (ROWS * 128) + (ks & 3) * 32, 16,
                    1024);
}

// Slab c of a tile of ROWS rows as an MN-major B operand (N = 64 head-dim
// columns, K = the tile's rows), k16 step kk: 16 rows, 2048 bytes, per
// step.  With N = 64 the operand is one swizzle atom wide, so only the
// stride between 8-row groups (1024 bytes) is read; both offsets carry it.
template <int ROWS>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int c, int kk) {
  return sw128_desc(tile + c * (ROWS * 128) + kk * 2048, 1024, 1024);
}

// d (64 × 64, float32) += A · B, both operands in shared memory, K-major.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 × 64, float32) += A · B, A (64 × 16 bf16) in registers, B in
// shared memory, MN-major (transpose bit set).
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------- tile movement

// Rows [t0, t0 + ROWS) of one head of a (B, T, H, D) bf16 tensor into a
// swizzled tile at shared address dst; rows at or past T and the padding
// columns of D = 32 are zero-filled.  Issued by NT threads (tid in
// [0, NT)), 16 bytes each per copy, neighbouring threads on neighbouring
// addresses.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* base,
                                          long long st, int t0, int T_len,
                                          int tid) {
  constexpr int G = slabs<D>() * 8;  // 16-byte groups per padded row
  static_assert(ROWS * G % NT == 0, "threads must divide the tile");
#pragma unroll
  for (int it = 0; it < ROWS * G / NT; ++it) {
    const int idx = it * NT + tid;
    const int r = idx / G, gg = idx % G;
    const int g = gg & 7;
    const int t = t0 + r;
    const bool ok = t < T_len && gg * 8 < D;
    const bf16* src = ok ? base + t * st + gg * 8 : base;
    cp_async16(dst + (gg >> 3) * (ROWS * 128) + r * 128 + ((g ^ (r & 7)) << 4),
               src, ok);
  }
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t s = smem_u32(p);
  return p + (((s + 1023u) & ~1023u) - s);
}

}  // namespace repro_sm90

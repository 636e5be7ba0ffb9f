// Kernels C and D, pair route, bf16: the FlashAttention-2 backward of one
// partial attention chunk on Hopper's tensor cores (sm_90a `wgmma`),
// written by hand, with plain C entry points bound via ctypes, templated on
// the q/k and v head dims <DK, DV>.  Two instantiations:
//   <192, 128>: materialised multi-head latent attention (DeepSeek MLA),
//     which deepseek-v2-lite-16b trains through: per head, q/k are the nope
//     128 ⊕ rope 64 columns and v the 128 up-projected value columns.
//   <160, 160>: the shared attention block of zamba2-2.7b (32 heads of 160).
//     The one-D route (flash_bwd_sm90.cu) holds dk and dv in registers of
//     two blocks an SM and has none left at 128.
// float32 inputs take the CUDA-core route (flash_bwd.cu at the same pairs);
// the other one-D head dims take flash_bwd_sm90.cu.
//
// Replaces the TPU kernels of the JAX package's `flash_bwd_bhtd`
// (src/repro/kernels/flash_attention.py) at that shape, for bf16:
//   C `_dq_kernel`  (:280, pallas_call at :417) -> flash_bwd_dq_pair_kernel
//   D `_dkv_kernel` (:322, pallas_call at :450) -> flash_bwd_dkv_pair_kernel
//
// Bound on the H100: operations.  deepseek-v2-lite-16b's attention backward
// at 8192 tokens (B 1, 16 heads, causal) has 5.369e8 unmasked (row, key)
// pairs.  C needs 2·(192 + 128 + 192) = 1,024 FLOPs a pair (s = q·kᵀ,
// dp = do·vᵀ, dq += ds·k), D 2·(192 + 128 + 128 + 192) = 1,280 (sᵀ, dpᵀ,
// dv += pᵀ·do, dk += dsᵀ·q): 0.550 and 0.687 TFLOP over 253 MB each, so
// the least times are the bf16 tensor-core rate's (989 TFLOP/s) 0.556 and
// 0.695 ms.  What the design does about it: every product runs once on
// the tensor cores (D does exactly its 1,280 FLOPs a pair; C does 1,408,
// ds entering dq as two bf16 terms), loads run on a producer warp by TMA,
// and two consumer warpgroups split each tile pair's products so that one
// warpgroup's exponentials and packing overlap the other's products.
//
// Design.  Three warpgroups a block (384 threads), one block an SM.
//   Producer (warpgroup 2; `setmaxnreg` down to 24 registers; one warp
//   works).  Lane 0 requests tiles by TMA (4-d tensor maps over (D, H, T,
//   B), 64-row × 64-column boxes in the 128-byte-swizzled layout `wgmma`
//   reads, rows past T arriving as zeros): the block's resident tiles once,
//   then a ring of 3 stages with `full` / `empty` mbarriers.  Every lane
//   copies its rows' statistics (lse, delta, segment ids) by cp.async,
//   whose completion lands on the stage's `full` barrier, so the producer
//   never waits on a load.  v may be a strided view (the last 128 columns
//   of the (…, 256) up-projection): its rows are 512 bytes apart, which
//   TMA takes as they lie.
//   Consumers (warpgroups 0 and 1; 240 registers each).  Their m64n64
//   accumulators share one fragment layout, so thread i of one warpgroup
//   owns the (row, column) positions thread i of the other owns: a tile of
//   p (or pᵀ) passes between them in float32, in fragment order, through a
//   16 KB shared buffer laid out [element / 4][thread] as float4s (no bank
//   conflicts).  Two such buffers, with full / empty named barriers over
//   the 256 consumer threads, let the first warpgroup run one tile ahead.
//   Each consumer holds its resident tile's A fragments in registers (the
//   first product's A operand) and, within a step, issues this tile's first
//   product, then the previous tile's second product, and forms p or ds
//   while the second product runs (FlashAttention-3's order: the second
//   product's A fragments are the only thing carried across steps).  The
//   exponentials are taken without a branch an element, and the mask runs
//   on edge tiles only.
//   D: one block per (64-key kv tile, kv head, batch row), heaviest first;
//      k (3 slabs) and v (2) stay resident, and the ring holds the next
//      (query head, q tile) items of the transposed host table
//      (kernels/block_sparse.q_block_bounds) over the GQA group: q (3
//      slabs), do (2), lse, delta and whether the tile needs the mask.
//      Warpgroup 0 computes sᵀ = k·qᵀ (12 k16 steps, k in registers), pᵀ =
//      exp2(sᵀ·scale·log2 e − lse·log2 e) in float32, hands pᵀ over, and
//      accumulates dv += pᵀ·do (pᵀ in bf16 as the register A operand, do
//      MN-major, m64n128).  Warpgroup 1 computes dpᵀ = v·doᵀ (8 k16 steps,
//      v in registers) meanwhile, takes pᵀ, forms dsᵀ = pᵀ·(dpᵀ − delta)·
//      scale and accumulates dk += dsᵀ·q (m64n192, q MN-major across its 3
//      slabs).  Each product runs once, sᵀ included: 64·64·192 +
//      64·128·64 multiply-adds an item on each warpgroup.  dk (96 float32 a
//      thread) and dv (64) are summed over the group on chip and written
//      once.
//   C: one block per (64-row q tile, query head, batch row), heaviest
//      first; q and do stay resident, and the ring holds the tile's valid
//      64-key tiles [lo, hi] of the forward's table
//      (kernels/block_sparse.kv_block_bounds): k (3 slabs), v (2), the key
//      segment ids.  Warpgroup 1 computes delta = rowsum(o ⊙ do) in the
//      prologue (float32; written for D unless the caller passed it).  Per
//      kv tile, warpgroup 0 computes s = q·kᵀ (q in registers) and p
//      (float32) and hands p over; warpgroup 1 computes dp = do·vᵀ (do in
//      registers), forms ds = p·(dp − delta)·scale and splits it into bf16
//      hi and the rounding remainder lo (a row's ds sums to zero over its
//      keys, and one bf16 term would let the keys' common component into
//      dq).  Warpgroup 1 writes hi (8 KB, swizzled K-major) for warpgroup 0,
//      which runs dq_a += hi·k as a shared-shared product, and keeps lo as
//      the register A operand of its own dq_b += lo·k (both m64n192, k
//      MN-major).  At the end dq = dq_a + dq_b, summed in float32 through
//      shared memory.  s and dp are each computed once per tile pair.
//   Registers: D 223 and C 235 of the 240 a consumer thread holds at
//   <192, 128>, no spill (chip_smoke.py's build phase checks it).
//   At <160, 160> every tile is three slabs, the last one's 32 columns past
//   160 read as zeros by TMA and never written back; dv and dk, and C's
//   dq_a and dq_b, run as m64n192 (96 float32 accumulators a thread), so the
//   first products read their resident A operand from shared memory (mma_ss)
//   instead of registers, and the ring holds two 48 KiB stages (three would
//   need 240 KiB of shared memory in C).  zamba2's training step (T 8192, 32
//   heads, causal: 1.074e9 pairs) is bound at 1.042 ms (C: 960 FLOPs a
//   pair) and 1.390 ms (D: 1,280).  No p or ds tile goes through
//   device memory, and there are no atomics: each run gives the same bits.
//   A row whose lse is NEG_INF (nothing to attend) gives p = 0, and so does
//   a row past a ragged Tq.  p and ds are rounded to bf16 before the second
//   products, as any tensor-core backward does, so the results are held to
//   a per-row relative bar (kernels/ref.row_rel_err).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd_common.cuh"
#include "sm90_common.cuh"
#include "sm90_tma.cuh"

namespace {

using repro_bwd::BwdParams;
using repro_bwd::Shape;
using repro_bwd::kNegInf;
using namespace repro_sm90;

constexpr int kTile = 64;           // q rows and keys a tile
constexpr int kThreads = 384;       // consumers 0 and 1, producer 2
constexpr uint32_t kSlab = kTile * 128;          // a 64 × 64 bf16 slab
constexpr uint32_t kHand = 32 * 128 * 4;         // a float32 hand-off buffer

// The tiles at head dims <DK, DV> (q/k and v): 64-column slabs, the last
// one zero-padded (TMA reads the columns past a head dim as zeros) when a
// head dim is not a multiple of 64.
template <int DK, int DV>
struct Dims {
  static constexpr int KSL = (DK + 63) / 64;  // slabs of a q or k tile
  static constexpr int VSL = (DV + 63) / 64;  // of a do or v tile
  static constexpr uint32_t TK = KSL * kSlab;       // a q or k tile
  static constexpr uint32_t TV = VSL * kSlab;       // a do or v tile
  static constexpr uint32_t kPair = TK + TV;        // resident tiles; a stage
  // items (D) or kv tiles (C) in the ring: three 40 KiB stages at
  // <192, 128>, two 48 KiB ones at <160, 160> (three would need 240 KiB in C)
  static constexpr int kStages = DV == 128 ? 3 : 2;
  // the first product's A operand (the resident tile) in registers; at
  // <160, 160> the second product's accumulators are 96 floats in every
  // consumer, and the A operand is read from shared memory instead, so that
  // no consumer needs more than its 240 registers
  static constexpr bool kRegA = DV == 128;
  static_assert(DK % 16 == 0 && DV % 16 == 0 && KSL == 3 &&
                    (VSL == 2 || VSL == 3), "head dims");
};
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
// named barriers (0 is __syncthreads)
constexpr int kDeltaBar = 1;   // warpgroup 1 alone, C's prologue
constexpr int kPFull = 2;      // + buffer: p / pᵀ written
constexpr int kPEmpty = 4;     // + buffer: p / pᵀ read
constexpr int kHFull = 6;      // + buffer: C's hi written
constexpr int kHEmpty = 8;     // + buffer: C's hi read
constexpr int kEpiBar = 10;    // C's epilogue

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// x as lane 0 holds it: a value the compiler knows is uniform across the
// warp.  The role branches and the sweep bounds (read from the host table)
// go through it, so that no `wgmma` sits on a path the compiler takes for
// divergent, where it would serialize them.
__device__ __forceinline__ int uniform(int x) {
  return __shfl_sync(0xffffffffu, x, 0);
}

__device__ __forceinline__ int warpgroup() {
  return uniform(static_cast<int>(threadIdx.x) >> 7);
}

template <int N>
__device__ __forceinline__ void regs_down() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_up() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// An arrival on the barrier once every cp.async this thread has issued has
// landed (one of the arrivals the barrier's phase counts).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// One arrival a warp on a ring's `empty` barrier, once the warp's products
// no longer read the stage: lane 0's, predicated rather than branched to.
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(smem_u32(bar)),
      "r"(threadIdx.x & 31)
      : "memory");
}

// The MaskSpec of one (query, key) pair (flash_bwd_common.cuh's `allowed`)
// without branches on per-thread values.
__device__ __forceinline__ bool allowed_bits(const BwdParams& a, int qp, int kp,
                                             int qs, int ks) {
  const bool pre = (a.prefix_len > 0) & (kp < a.prefix_len);
  const bool causal = !a.causal | (kp <= qp) | pre;
  const bool window = (a.window <= 0) | (qp - kp < a.window) | pre;
  const bool seg = !a.has_seg | (qs == ks) | pre;
  return causal & window & seg;
}


// Spins until phase `parity` of the barrier has completed, and traps after
// 2^26 polls (a fault in the ring's bookkeeping fails the launch instead of
// hanging the card).  The loop lives in one asm block: a loop on a
// per-thread value in the compiler's view makes it take the `wgmma`s after
// it for divergent and serialize every one of them.
__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\nmov.u32 n, 0;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE_%=;\n"
      "add.u32 n, n, 1;\n"
      "setp.lt.u32 p, n, 67108864;\n"
      "@p bra WAIT_%=;\n"
      "trap;\n"
      "DONE_%=:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// d (64 × 64, float32) = A · B (acc 0) or d += A · B (acc 1), A (64 × 16
// bf16) in registers, B in shared memory, K-major.
__device__ __forceinline__ void mma64_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// This thread's A fragments of a resident 64-row swizzled tile at `tile`
// (K-major, KS k16 steps): word f of step ks holds row r0 + 8·(f & 1),
// columns 16·ks + 8·(f >> 1) + 2·(lane % 4) and the next.
template <int KS>
__device__ __forceinline__ void load_a(uint32_t (&a)[KS][4],
                                       const unsigned char* tile, int warp,
                                       int lane) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int row = 16 * warp + (lane >> 2) + 8 * (f & 1);
      const int g = 2 * (ks & 3) + (f >> 1);
      a[ks][f] = *reinterpret_cast<const uint32_t*>(
          tile + (ks >> 2) * kSlab + row * 128 + ((g ^ (row & 7)) << 4) +
          4 * (lane & 3));
    }
}

// An MN-major B operand of N = 64·slabs columns across the 64-column slabs
// of a 64-row tile, k16 step kk (16 rows): the leading byte offset is the
// slab stride, the stride byte offset the 1024 bytes between 8-row groups.
__device__ __forceinline__ uint64_t mn_wide(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 2048, kSlab, 1024);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// d (64 × 192, float32) += A · B, A (64 × 16 bf16) in shared memory,
// K-major, B in shared memory, MN-major (transpose bit set) across three
// 64-column slabs.
__device__ __forceinline__ void mma_ss_n192(float (&d0)[32], float (&d1)[32],
                                            float (&d2)[32], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
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
      "}, %96, %97, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

// Dynamic shared memory of kernel D: k and v, the ring's stages (q, do),
// two hand-off buffers, each stage's lse, delta and q segment ids and its
// edge flag (padded to 8 bytes), the mbarriers (kv, full and empty a
// stage), room to align to 1024 bytes.
template <int DK, int DV>
constexpr size_t dkv_smem_bytes() {
  using T = Dims<DK, DV>;
  constexpr int kStages = T::kStages;
  return (1 + kStages) * T::kPair + 2 * kHand + kStages * 3 * kTile * 4 +
         2 * kStages * 4 + (1 + 2 * kStages) * 8 + 1024;
}

// Of kernel C: q and do, the ring's stages (k, v), two hand-off buffers,
// two hi tiles, each stage's key segment ids, delta, the mbarriers (q, full
// and empty a stage), room to align.
template <int DK, int DV>
constexpr size_t dq_smem_bytes() {
  using T = Dims<DK, DV>;
  constexpr int kStages = T::kStages;
  return (1 + kStages) * T::kPair + 2 * kHand + 2 * kSlab + kStages * kTile * 4 +
         kTile * 4 + (1 + 2 * kStages) * 8 + 1024;
}

// ---------------------------------------------------------------- kernel D

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_pair_kernel(const BwdParams a,
                              const __grid_constant__ CUtensorMap tmq,
                              const __grid_constant__ CUtensorMap tmk,
                              const __grid_constant__ CUtensorMap tmv,
                              const __grid_constant__ CUtensorMap tmdo) {
  using T = Dims<DK, DV>;
  constexpr int KSL = T::KSL, VSL = T::VSL, kStages = T::kStages;
  constexpr uint32_t TK = T::TK, kPair = T::kPair;
  constexpr bool kRegA = T::kRegA;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t sK = smem_u32(smem), sV = sK + TK;
  const uint32_t sRing = sK + kPair;            // stage s: q, then do
  float* hand = reinterpret_cast<float*>(smem + (1 + kStages) * kPair);
  float* sL = hand + 2 * (kHand / 4);           // [stage][row]
  float* sDl = sL + kStages * kTile;
  int* sQs = reinterpret_cast<int*>(sDl + kStages * kTile);
  int* sEdge = sQs + kStages * kTile;  // the item's tile needs the mask
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(sEdge + 2 * kStages);
  uint64_t* full = kvfull + 1;
  uint64_t* empty = full + kStages;

  const int hk = blockIdx.x, kt = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = warpgroup(), t128 = tid & 127;
  const int warp = t128 >> 5, lane = tid & 31;
  const int k0 = kt * kTile;
  const int qlo = uniform(a.qbounds[2 * kt]);
  const int qhi = uniform(a.qbounds[2 * kt + 1]);
  const int nqt = qhi >= qlo ? qhi - qlo + 1 : 0;
  const int items = nqt * a.group;  // (query head, q tile) pairs to sweep

  if (tid == 0) {
    mbar_init(kvfull, 1);
    for (int s = 0; s < kStages; ++s) {
      // lane 0's bytes; every lane's arrival, then its rows' cp.asyncs
      mbar_init(full + s, 1 + 2 * 32);
      mbar_init(empty + s, 8);      // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // ------------------------------------------- producer
    regs_down<kProducerRegs>();
    if (warp != 0 || items == 0) return;
    if (lane == 0) {
      mbar_expect_tx(kvfull, kPair);
#pragma unroll
      for (int c = 0; c < KSL; ++c)
        tma_load_4d(sK + c * kSlab, &tmk, 64 * c, hk, k0, b, kvfull);
#pragma unroll
      for (int c = 0; c < VSL; ++c)
        tma_load_4d(sV + c * kSlab, &tmv, 64 * c, hk, k0, b, kvfull);
    }
    for (int n = 0; n < items; ++n) {
      const int s = n % kStages;
      wait_phase(empty + s, ((n / kStages) & 1) ^ 1);
      const int h = hk * a.group + n / nqt;
      const int qi = qlo + n % nqt, q0 = qi * kTile;
      const uint32_t st = sRing + s * kPair;
      if (lane == 0) {
        mbar_expect_tx(full + s, kPair);
#pragma unroll
        for (int c = 0; c < KSL; ++c)
          tma_load_4d(st + c * kSlab, &tmq, 64 * c, h, q0, b, full + s);
#pragma unroll
        for (int c = 0; c < VSL; ++c)
          tma_load_4d(st + TK + c * kSlab, &tmdo, 64 * c, h, q0, b,
                      full + s);
      }
      // the rows' statistics by cp.async, landing on the stage's barrier
      // (rows past Tq read 0, and edge tiles mask them)
      for (int r = lane; r < kTile; r += 32) {
        const int t = q0 + r;
        const bool ok = t < a.Tq;
        const long long si = ((long long)b * a.Tq + (ok ? t : 0)) * a.Hq + h;
        cp_async4(sL + s * kTile + r, a.lse + si, ok);
        cp_async4(sDl + s * kTile + r, a.delta + si, ok);
        if (a.has_seg)
          cp_async4(sQs + s * kTile + r, a.qseg + b * a.qs_sb + (ok ? t : 0),
                    ok);
      }
      // interior tiles (every pair attends) come from the forward's table
      if (lane == 0)
        sEdge[s] = (a.masked && (kt < a.bounds[4 * qi + 2] ||
                                 kt > a.bounds[4 * qi + 3])) ||
                   k0 + kTile > a.Tk || q0 + kTile > a.Tq;
      mbar_arrive(full + s);  // lane 0's edge flag is written
      cp_async_arrive(full + s);
    }
  } else if (wg == 0) {  // ------------------ consumer 0: sᵀ, pᵀ and dv
    regs_up<kConsumerRegs>();
    // This thread's accumulator rows are keys kr[0] and kr[1] = kr[0] + 8.
    const int kr[2] = {16 * warp + (lane >> 2), 16 * warp + (lane >> 2) + 8};
    const int c0 = 2 * (lane & 3);
    const float scale2 = a.scale * kLog2e;
    int ks[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kl = k0 + kr[r];
      ks[r] = a.has_seg && kl < a.Tk ? a.kseg[b * a.ks_sb + kl] : 0;
    }
    float dv[VSL][32];  // dv's 64-column slabs
#pragma unroll
    for (int c = 0; c < VSL; ++c) zero(dv[c]);
    // Item n issues sᵀ(n), then dv += pᵀ(n − 1)·do(n − 1), and forms pᵀ(n)
    // while the second product runs.
    uint32_t pa[4][4];  // pᵀ(n − 1) in bf16, the A fragments of dv's product
    auto dv_product = [&](int n) {
      const uint32_t gt = sRing + (n % kStages) * kPair + TK;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (VSL == 2)
          mma_rs_n128(dv[0], dv[1], pa[kk], mn_wide(gt, kk));
        else
          mma_rs_n192(dv[0], dv[1], dv[2], pa[kk], mn_wide(gt, kk));
      }
      wg_commit();
    };
    uint32_t ka[DK / 16][4];  // k, the A operand of every sᵀ (kRegA)
    if (items > 0) {
      wait_phase(kvfull, 0);
      if constexpr (kRegA) load_a(ka, smem, warp, lane);
    }
    for (int n = 0; n < items; ++n) {
      const int s = n % kStages;
      const int qi = qlo + n % nqt, q0 = qi * kTile;
      const uint32_t qt = sRing + s * kPair;
      wait_phase(full + s, (n / kStages) & 1);
      float st[32];  // sᵀ: rows are keys, columns q rows
      if constexpr (!kRegA) {
        zero(st);
        fence_regs(st);  // written before the fence, not sunk past it
      }
      wg_fence();
#pragma unroll
      for (int k = 0; k < DK / 16; ++k) {
        if constexpr (kRegA)
          mma64_rs(st, ka[k], kmajor<kTile>(qt, k), k > 0);
        else
          mma_ss(st, kmajor<kTile>(sK, k), kmajor<kTile>(qt, k));
      }
      wg_commit();
      if (n > 0) {
        dv_product(n - 1);
        wg_wait<1>();
      } else {
        wg_wait<0>();
      }
      fence_regs(st);

      // pᵀ = exp2(sᵀ·scale·log2 e − lse·log2 e), every exponential taken
      // and the dead ones selected away (no branch an element); the mask on
      // edge tiles only, rows past Tq included
      float Lq[16];  // lse · log2 e of this thread's 16 columns
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const float2 l =
            *reinterpret_cast<const float2*>(sL + s * kTile + 8 * g + c0);
        Lq[2 * g] = l.x * kLog2e;
        Lq[2 * g + 1] = l.y * kLog2e;
      }
      if (uniform(sEdge[s])) {
        const int* Qs = sQs + s * kTile;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int j = 2 * (i >> 2) + (i & 1);
          const int col = 8 * (i >> 2) + c0 + (i & 1);
          const int kl = k0 + kr[(i >> 1) & 1];
          const float e = exp2_approx(fmaf(st[i], scale2, -Lq[j]));
          const bool ok =
              (Lq[j] > kNegInf * 0.5f) & (kl < a.Tk) & (q0 + col < a.Tq) &
              allowed_bits(a, a.q_offset + q0 + col, a.kv_offset + kl,
                           a.has_seg ? Qs[col] : 0, ks[(i >> 1) & 1]);
          st[i] = ok ? e : 0.f;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int j = 2 * (i >> 2) + (i & 1);
          const float e = exp2_approx(fmaf(st[i], scale2, -Lq[j]));
          st[i] = Lq[j] > kNegInf * 0.5f ? e : 0.f;
        }
      }

      // pᵀ to warpgroup 1, in float32 and fragment order
      const int pb = n & 1;
      if (n >= 2) named_sync(kPEmpty + pb, 256);
      float4* hp = reinterpret_cast<float4*>(hand) + pb * (kHand / 16);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        hp[j * 128 + t128] =
            make_float4(st[4 * j], st[4 * j + 1], st[4 * j + 2], st[4 * j + 3]);
      named_arrive(kPFull + pb, 256);

      if (n > 0) {  // item n − 1's products are done: free its stage
        wg_wait<0>();
#pragma unroll
        for (int c = 0; c < VSL; ++c) fence_regs(dv[c]);
        release(empty + (n - 1) % kStages);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f)
          pa[kk][f] = pack_bf16(st[8 * kk + 2 * f], st[8 * kk + 2 * f + 1]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
    }
    if (items > 0) {
      wg_fence();
      dv_product(items - 1);
      wg_wait<0>();
#pragma unroll
      for (int c = 0; c < VSL; ++c) fence_regs(dv[c]);
      release(empty + (items - 1) % kStages);
    }

    bf16* vo = static_cast<bf16*>(a.dv) + b * a.dv_sb + hk * a.dv_sh;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int t = k0 + kr[(i >> 1) & 1];
      const int col = 8 * (i >> 2) + c0;
      if (t < a.Tk) {
#pragma unroll
        for (int c = 0; c < VSL; ++c)
          if (64 * c + 8 * (i >> 2) < DV)  // the zero slab's columns stay
            *reinterpret_cast<__nv_bfloat162*>(vo + t * a.dv_st + 64 * c +
                                               col) =
                __floats2bfloat162_rn(dv[c][i], dv[c][i + 1]);
      }
    }
  } else {  // ------------------------------ consumer 1: dpᵀ, dsᵀ and dk
    regs_up<kConsumerRegs>();
    const int kr[2] = {16 * warp + (lane >> 2), 16 * warp + (lane >> 2) + 8};
    const int c0 = 2 * (lane & 3);
    float dk0[32], dk1[32], dk2[32];
    zero(dk0);
    zero(dk1);
    zero(dk2);
    // Item n issues dpᵀ(n), then dk += dsᵀ(n − 1)·q(n − 1), and forms
    // dsᵀ(n) while the second product runs.
    uint32_t da[4][4];  // dsᵀ(n − 1) in bf16, the A fragments of dk's product
    auto dk_product = [&](int n) {
      const uint32_t qt = sRing + (n % kStages) * kPair;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs_n192(dk0, dk1, dk2, da[kk], mn_wide(qt, kk));
      wg_commit();
    };
    uint32_t va[DV / 16][4];  // v, the A operand of every dpᵀ (kRegA)
    if (items > 0) {
      wait_phase(kvfull, 0);
      if constexpr (kRegA) load_a(va, smem + TK, warp, lane);
    }
    for (int n = 0; n < items; ++n) {
      const int s = n % kStages;
      const uint32_t gt = sRing + s * kPair + TK;
      wait_phase(full + s, (n / kStages) & 1);
      float dpt[32];  // dpᵀ, then dsᵀ in float32
      if constexpr (!kRegA) {
        zero(dpt);
        fence_regs(dpt);
      }
      wg_fence();
#pragma unroll
      for (int k = 0; k < DV / 16; ++k) {
        if constexpr (kRegA)
          mma64_rs(dpt, va[k], kmajor<kTile>(gt, k), k > 0);
        else
          mma_ss(dpt, kmajor<kTile>(sV, k), kmajor<kTile>(gt, k));
      }
      wg_commit();
      if (n > 0) {
        dk_product(n - 1);
        wg_wait<1>();
      } else {
        wg_wait<0>();
      }
      fence_regs(dpt);

      // dsᵀ = pᵀ·(dpᵀ − delta)·scale
      const int pb = n & 1;
      named_sync(kPFull + pb, 256);
      const float4* hp =
          reinterpret_cast<const float4*>(hand) + pb * (kHand / 16);
      const float* Dl = sDl + s * kTile;
#pragma unroll
      for (int g = 0; g < 8; ++g) {  // 8-column groups
        const float4 p = hp[g * 128 + t128];
        const float2 d = *reinterpret_cast<const float2*>(Dl + 8 * g + c0);
        const int i = 4 * g;
        dpt[i] = p.x * (dpt[i] - d.x) * a.scale;
        dpt[i + 1] = p.y * (dpt[i + 1] - d.y) * a.scale;
        dpt[i + 2] = p.z * (dpt[i + 2] - d.x) * a.scale;
        dpt[i + 3] = p.w * (dpt[i + 3] - d.y) * a.scale;
      }
      if (n + 2 < items) named_arrive(kPEmpty + pb, 256);

      if (n > 0) {  // item n − 1's products are done: free its stage
        wg_wait<0>();
        fence_regs(dk0);
        fence_regs(dk1);
        fence_regs(dk2);
        release(empty + (n - 1) % kStages);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f)
          da[kk][f] = pack_bf16(dpt[8 * kk + 2 * f], dpt[8 * kk + 2 * f + 1]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(da[kk]);
    }
    if (items > 0) {
      wg_fence();
      dk_product(items - 1);
      wg_wait<0>();
      fence_regs(dk0);
      fence_regs(dk1);
      fence_regs(dk2);
      release(empty + (items - 1) % kStages);
    }

    bf16* ko = static_cast<bf16*>(a.dk) + b * a.dk_sb + hk * a.dk_sh;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int t = k0 + kr[(i >> 1) & 1];
      const int col = 8 * (i >> 2) + c0;
      if (t < a.Tk) {
        bf16* row = ko + t * a.dk_st + col;
        *reinterpret_cast<__nv_bfloat162*>(row) =
            __floats2bfloat162_rn(dk0[i], dk0[i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(row + 64) =
            __floats2bfloat162_rn(dk1[i], dk1[i + 1]);
        if (128 + 8 * (i >> 2) < DK)  // the zero slab's columns stay
          *reinterpret_cast<__nv_bfloat162*>(row + 128) =
              __floats2bfloat162_rn(dk2[i], dk2[i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------- kernel C

__device__ __forceinline__ float dot8(const uint4& x, const uint4& y,
                                      float acc) {
  const __nv_bfloat162* u = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* w = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fu = __bfloat1622float2(u[i]);
    const float2 fw = __bfloat1622float2(w[i]);
    acc = fmaf(fu.x, fw.x, acc);
    acc = fmaf(fu.y, fw.y, acc);
  }
  return acc;
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_pair_kernel(const BwdParams a,
                             const __grid_constant__ CUtensorMap tmq,
                             const __grid_constant__ CUtensorMap tmk,
                             const __grid_constant__ CUtensorMap tmv,
                             const __grid_constant__ CUtensorMap tmdo) {
  using T = Dims<DK, DV>;
  constexpr int KSL = T::KSL, VSL = T::VSL, kStages = T::kStages;
  constexpr uint32_t TK = T::TK, kPair = T::kPair;
  constexpr bool kRegA = T::kRegA;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t sQ = smem_u32(smem), sDO = sQ + TK;
  const uint32_t sRing = sQ + kPair;            // stage s: k, then v
  float* hand = reinterpret_cast<float*>(smem + (1 + kStages) * kPair);
  const uint32_t sH = smem_u32(hand + 2 * (kHand / 4));  // two hi tiles
  int* sKs = reinterpret_cast<int*>(smem + (1 + kStages) * kPair +
                                    2 * kHand + 2 * kSlab);  // [stage][key]
  float* sDl = reinterpret_cast<float*>(sKs + kStages * kTile);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(sDl + kTile);
  uint64_t* full = qfull + 1;
  uint64_t* empty = full + kStages;
  // dq_b on its way to warpgroup 0, once every kv tile is done: the ring
  float4* red = reinterpret_cast<float4*>(smem + kPair);

  const int h = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y, b = blockIdx.z;
  const int hk = h / a.group;
  const int tid = threadIdx.x, wg = warpgroup(), t128 = tid & 127;
  const int warp = t128 >> 5, lane = tid & 31;
  const int q0 = qt * kTile;
  const int lo = uniform(a.bounds[4 * qt]), hi = uniform(a.bounds[4 * qt + 1]);
  const int ntiles = hi >= lo ? hi - lo + 1 : 0;

  if (tid == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1 + 32);
      mbar_init(empty + s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // This thread's accumulator rows (both consumers): rr[0], rr[1] = + 8.
  const int rr[2] = {16 * warp + (lane >> 2), 16 * warp + (lane >> 2) + 8};
  const int c0 = 2 * (lane & 3);

  if (wg == 2) {  // ------------------------------------------- producer
    regs_down<kProducerRegs>();
    if (warp != 0 || ntiles == 0) return;
    if (lane == 0) {
      mbar_expect_tx(qfull, kPair);
#pragma unroll
      for (int c = 0; c < KSL; ++c)
        tma_load_4d(sQ + c * kSlab, &tmq, 64 * c, h, q0, b, qfull);
#pragma unroll
      for (int c = 0; c < VSL; ++c)
        tma_load_4d(sDO + c * kSlab, &tmdo, 64 * c, h, q0, b, qfull);
    }
    for (int n = 0; n < ntiles; ++n) {
      const int s = n % kStages;
      wait_phase(empty + s, ((n / kStages) & 1) ^ 1);
      const int kk0 = (lo + n) * kTile;
      const uint32_t st = sRing + s * kPair;
      if (lane == 0) {
        mbar_expect_tx(full + s, kPair);
#pragma unroll
        for (int c = 0; c < KSL; ++c)
          tma_load_4d(st + c * kSlab, &tmk, 64 * c, hk, kk0, b, full + s);
#pragma unroll
        for (int c = 0; c < VSL; ++c)
          tma_load_4d(st + TK + c * kSlab, &tmv, 64 * c, hk, kk0, b,
                      full + s);
      }
      if (a.has_seg) {
        for (int r = lane; r < kTile; r += 32) {
          const int t = kk0 + r;
          sKs[s * kTile + r] = t < a.Tk ? a.kseg[b * a.ks_sb + t] : -1;
        }
      }
      mbar_arrive(full + s);
    }
  } else if (wg == 0) {  // --------------- consumer 0: s, p and dq_a = hi·k
    regs_up<kConsumerRegs>();
    const int ilo = a.bounds[4 * qt + 2], ihi = a.bounds[4 * qt + 3];
    const float scale2 = a.scale * kLog2e;
    float Ls[2];
    bool live[2];
    int qp[2], qs[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = q0 + rr[r];
      const float L =
          t < a.Tq ? a.lse[((long long)b * a.Tq + t) * a.Hq + h] : kNegInf;
      live[r] = L > kNegInf * 0.5f;
      Ls[r] = L * kLog2e;
      qp[r] = a.q_offset + t;
      qs[r] = a.has_seg && t < a.Tq ? a.qseg[b * a.qs_sb + t] : -1;
    }
    float dq0[32], dq1[32], dq2[32];
    zero(dq0);
    zero(dq1);
    zero(dq2);
    // Tile n issues s(n), then dq_a += hi(n − 1)·k(n − 1), and forms p(n)
    // while the second product runs.
    auto dq_product = [&](int n) {
      const uint32_t kt = sRing + (n % kStages) * kPair;
      const uint32_t ht = sH + (n & 1) * kSlab;
      named_sync(kHFull + (n & 1), 256);  // hi(n) from warpgroup 1
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_ss_n192(dq0, dq1, dq2, kmajor<kTile>(ht, kk), mn_wide(kt, kk));
      wg_commit();
    };
    uint32_t qa[DK / 16][4];  // q, the A operand of every s (kRegA)
    if (ntiles > 0) {
      wait_phase(qfull, 0);
      if constexpr (kRegA) load_a(qa, smem, warp, lane);
    }
    for (int n = 0; n < ntiles; ++n) {
      const int s = n % kStages;
      const int j = lo + n, kk0 = j * kTile;
      const uint32_t kt = sRing + s * kPair;
      wait_phase(full + s, (n / kStages) & 1);
      float sc[32];
      if constexpr (!kRegA) {
        zero(sc);
        fence_regs(sc);
      }
      wg_fence();
#pragma unroll
      for (int k = 0; k < DK / 16; ++k) {
        if constexpr (kRegA)
          mma64_rs(sc, qa[k], kmajor<kTile>(kt, k), k > 0);
        else
          mma_ss(sc, kmajor<kTile>(sQ, k), kmajor<kTile>(kt, k));
      }
      wg_commit();
      if (n > 0) {
        dq_product(n - 1);
        wg_wait<1>();
      } else {
        wg_wait<0>();
      }
      fence_regs(sc);

      // p = exp(s·scale − lse), every exponential taken and the dead ones
      // selected away (no branch an element); the mask on edge tiles only
      if (uniform((a.masked && (j < ilo || j > ihi)) || kk0 + kTile > a.Tk)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          const int col = 8 * (i >> 2) + c0 + (i & 1);
          const int kl = kk0 + col;
          const float e = exp2_approx(fmaf(sc[i], scale2, -Ls[r]));
          const bool ok = live[r] & (kl < a.Tk) &
                          allowed_bits(a, qp[r], a.kv_offset + kl, qs[r],
                                       a.has_seg ? sKs[s * kTile + col] : 0);
          sc[i] = ok ? e : 0.f;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float e = exp2_approx(fmaf(sc[i], scale2, -Ls[(i >> 1) & 1]));
          sc[i] = live[(i >> 1) & 1] ? e : 0.f;
        }
      }

      // p to warpgroup 1, in float32 and fragment order
      const int pb = n & 1;
      if (n >= 2) named_sync(kPEmpty + pb, 256);
      float4* hp = reinterpret_cast<float4*>(hand) + pb * (kHand / 16);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        hp[jj * 128 + t128] = make_float4(sc[4 * jj], sc[4 * jj + 1],
                                          sc[4 * jj + 2], sc[4 * jj + 3]);
      named_arrive(kPFull + pb, 256);

      if (n > 0) {  // tile n − 1's products are done: free hi and the stage
        wg_wait<0>();
        fence_regs(dq0);
        fence_regs(dq1);
        fence_regs(dq2);
        if (n + 1 < ntiles) named_arrive(kHEmpty + (pb ^ 1), 256);
        release(empty + (n - 1) % kStages);
      }
    }
    if (ntiles > 0) {
      wg_fence();
      dq_product(ntiles - 1);
      wg_wait<0>();
      fence_regs(dq0);
      fence_regs(dq1);
      fence_regs(dq2);
      release(empty + (ntiles - 1) % kStages);
    }

    // dq = dq_a + dq_b, dq_b from warpgroup 1 in fragment order
    named_sync(kEpiBar, 256);  // every product is done: the ring is free
    named_sync(kEpiBar, 256);  // dq_b is in it
    bf16* out = static_cast<bf16*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
    const int t0 = q0 + rr[0], t1 = q0 + rr[1];
    auto put = [&](const float (&d)[32], int c) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float4 x = red[(8 * c + jj) * 128 + t128];
        const int col = 64 * c + 8 * jj + c0;
        if (64 * c + 8 * jj >= DK) continue;  // the zero slab's columns
        if (t0 < a.Tq)
          *reinterpret_cast<__nv_bfloat162*>(out + t0 * a.dq_st + col) =
              __floats2bfloat162_rn(d[4 * jj] + x.x, d[4 * jj + 1] + x.y);
        if (t1 < a.Tq)
          *reinterpret_cast<__nv_bfloat162*>(out + t1 * a.dq_st + col) =
              __floats2bfloat162_rn(d[4 * jj + 2] + x.z, d[4 * jj + 3] + x.w);
      }
    };
    put(dq0, 0);
    put(dq1, 1);
    put(dq2, 2);
  } else {  // --------------------- consumer 1: dp, ds and dq_b = lo·k
    regs_up<kConsumerRegs>();
    // delta = rowsum(o ⊙ do): two threads a row, or the caller's
    if (a.compute_delta) {
      const bf16* dob =
          static_cast<const bf16*>(a.dout) + b * a.do_sb + h * a.do_sh;
      const bf16* ob = static_cast<const bf16*>(a.o) + b * a.o_sb + h * a.o_sh;
      const int row = t128 >> 1, half = t128 & 1;
      const int t = q0 + row;
      float acc = 0.f;
      if (t < a.Tq) {
        const bf16* orow = ob + t * a.o_st + half * (DV / 2);
        const bf16* grow = dob + t * a.do_st + half * (DV / 2);
#pragma unroll
        for (int c = 0; c < DV / 2; c += 8)
          acc = dot8(*reinterpret_cast<const uint4*>(orow + c),
                     *reinterpret_cast<const uint4*>(grow + c), acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (half == 0) {
        sDl[row] = acc;
        if (t < a.Tq) a.delta[((long long)b * a.Tq + t) * a.Hq + h] = acc;
      }
    } else if (t128 < kTile) {
      const int t = q0 + t128;
      sDl[t128] = t < a.Tq ? a.delta[((long long)b * a.Tq + t) * a.Hq + h]
                           : 0.f;
    }
    named_sync(kDeltaBar, 128);
    const float Dl[2] = {sDl[rr[0]], sDl[rr[1]]};

    float dq0[32], dq1[32], dq2[32];
    zero(dq0);
    zero(dq1);
    zero(dq2);
    // Tile n issues dp(n), then dq_b += lo(n − 1)·k(n − 1), and forms ds(n)
    // while the second product runs.
    uint32_t al[4][4];  // lo(n − 1), the A fragments of dq_b's product
    auto dq_product = [&](int n) {
      const uint32_t kt = sRing + (n % kStages) * kPair;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs_n192(dq0, dq1, dq2, al[kk], mn_wide(kt, kk));
      wg_commit();
    };
    uint32_t ga[DV / 16][4];  // do, the A operand of every dp (kRegA)
    if (ntiles > 0) {
      wait_phase(qfull, 0);
      if constexpr (kRegA) load_a(ga, smem + TK, warp, lane);
    }
    for (int n = 0; n < ntiles; ++n) {
      const int s = n % kStages;
      const uint32_t vt = sRing + s * kPair + TK;
      wait_phase(full + s, (n / kStages) & 1);
      float dp[32];  // dp, then ds in float32
      if constexpr (!kRegA) {
        zero(dp);
        fence_regs(dp);
      }
      wg_fence();
#pragma unroll
      for (int k = 0; k < DV / 16; ++k) {
        if constexpr (kRegA)
          mma64_rs(dp, ga[k], kmajor<kTile>(vt, k), k > 0);
        else
          mma_ss(dp, kmajor<kTile>(sDO, k), kmajor<kTile>(vt, k));
      }
      wg_commit();
      if (n > 0) {
        dq_product(n - 1);
        wg_wait<1>();
      } else {
        wg_wait<0>();
      }
      fence_regs(dp);

      // ds = p·(dp − delta)·scale
      const int pb = n & 1;
      named_sync(kPFull + pb, 256);
      const float4* hp =
          reinterpret_cast<const float4*>(hand) + pb * (kHand / 16);
#pragma unroll
      for (int g = 0; g < 8; ++g) {  // 8-column groups
        const float4 p = hp[g * 128 + t128];
        const int i = 4 * g;
        dp[i] = p.x * (dp[i] - Dl[0]) * a.scale;
        dp[i + 1] = p.y * (dp[i + 1] - Dl[0]) * a.scale;
        dp[i + 2] = p.z * (dp[i + 2] - Dl[1]) * a.scale;
        dp[i + 3] = p.w * (dp[i + 3] - Dl[1]) * a.scale;
      }
      if (n + 2 < ntiles) named_arrive(kPEmpty + pb, 256);

      // ds as two bf16 terms, hi + lo.  hi goes into the swizzled K-major
      // tile warpgroup 0 reads (row r's 16-byte group g at g ^ (r % 8),
      // this thread's 4 bytes at 2·c0); lo stays here.
      if (n >= 2) named_sync(kHEmpty + pb, 256);
      unsigned char* ht = reinterpret_cast<unsigned char*>(
          hand + 2 * (kHand / 4)) + pb * kSlab;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int i = 8 * kk + 2 * f;
          const int r = rr[f & 1], g = 2 * kk + (f >> 1);
          *reinterpret_cast<__nv_bfloat162*>(
              ht + r * 128 + ((g ^ (r & 7)) << 4) + 2 * c0) =
              __floats2bfloat162_rn(dp[i], dp[i + 1]);
        }
      fence_proxy_async();  // the generic writes, for wgmma's reads
      named_arrive(kHFull + pb, 256);

      if (n > 0) {  // tile n − 1's products are done: free its stage
        wg_wait<0>();
        fence_regs(dq0);
        fence_regs(dq1);
        fence_regs(dq2);
        release(empty + (n - 1) % kStages);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int i = 8 * kk + 2 * f;
          const float2 hf = __bfloat1622float2(
              __floats2bfloat162_rn(dp[i], dp[i + 1]));
          al[kk][f] = pack_bf16(dp[i] - hf.x, dp[i + 1] - hf.y);
        }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(al[kk]);
    }
    if (ntiles > 0) {
      wg_fence();
      dq_product(ntiles - 1);
      wg_wait<0>();
      fence_regs(dq0);
      fence_regs(dq1);
      fence_regs(dq2);
      release(empty + (ntiles - 1) % kStages);
    }

    named_sync(kEpiBar, 256);  // warpgroup 0's products are done too
    auto put = [&](const float (&d)[32], int c) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        red[(8 * c + jj) * 128 + t128] = make_float4(
            d[4 * jj], d[4 * jj + 1], d[4 * jj + 2], d[4 * jj + 3]);
    };
    put(dq0, 0);
    put(dq1, 1);
    put(dq2, 2);
    named_arrive(kEpiBar, 256);
  }
}

// ---------------------------------------------------------------- launch

// The four tensor maps of one call (q, k, v, do), 64-row boxes of one head;
// 0, or the CUresult of the one that could not be encoded.
template <int DK, int DV>
int maps(const BwdParams& p, const Shape& sh, CUtensorMap* m) {
  int r = tile_map(m, p.q, DK, p.Hq, p.Tq, sh.B, p.q_sh, p.q_st, p.q_sb, 1,
                   kTile);
  if (r == 0)
    r = tile_map(m + 1, p.k, DK, sh.Hkv, p.Tk, sh.B, p.k_sh, p.k_st, p.k_sb,
                 1, kTile);
  if (r == 0)
    r = tile_map(m + 2, p.v, DV, sh.Hkv, p.Tk, sh.B, p.v_sh, p.v_st, p.v_sb,
                 1, kTile);
  if (r == 0)
    r = tile_map(m + 3, p.dout, DV, p.Hq, p.Tq, sh.B, p.do_sh, p.do_st,
                 p.do_sb, 1, kTile);
  return r;
}

template <int DK, int DV, typename K>
int launch(K kernel, size_t smem, bool* sized, const BwdParams& p,
           const Shape& sh, dim3 grid, cudaStream_t s) {
  CUtensorMap m[4];
  const int r = maps<DK, DV>(p, sh, m);
  if (r != 0) return 1000 + r;
  if (!*sized) {  // the attribute is set once a process
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    *sized = true;
  }
  kernel<<<grid, kThreads, smem, s>>>(p, m[0], m[1], m[2], m[3]);
  return static_cast<int>(cudaGetLastError());
}

// the shared-memory attribute is set once a process for each kernel
template <int DK, int DV>
bool dq_sized = false;
template <int DK, int DV>
bool dkv_sized = false;

template <int DK, int DV>
int launch_dq(const BwdParams& p, const Shape& sh, cudaStream_t s) {
  return launch<DK, DV>(flash_bwd_dq_pair_kernel<DK, DV>,
                        dq_smem_bytes<DK, DV>(), &dq_sized<DK, DV>, p, sh,
                        dim3(p.Hq, sh.nq, sh.B), s);
}

template <int DK, int DV>
int launch_dkv(const BwdParams& p, const Shape& sh, cudaStream_t s) {
  return launch<DK, DV>(flash_bwd_dkv_pair_kernel<DK, DV>,
                        dkv_smem_bytes<DK, DV>(), &dkv_sized<DK, DV>, p, sh,
                        dim3(sh.Hkv, sh.nk, sh.B), s);
}

}  // namespace

// Kernel C's pair route, bf16 (ia's dtype must be 1, (D, Dv) (192, 128) or
// (160, 160); ia as in flash_bwd_common.cuh).  Writes dq and, when compute_delta, delta.
// Every row must start on 16 bytes.  Returns 0 when launched, else the CUDA
// error of the launch, or 1000 plus the CUresult of a tensor map that could
// not be encoded.
extern "C" int repro_flash_bwd_dq_pair_sm90(const void* q, const void* k,
                                            const void* v, const void* o,
                                            const void* dout, const void* lse,
                                            void* delta, void* dq,
                                            const void* bounds,
                                            const void* qseg, const void* kseg,
                                            const long long* ia, float scale,
                                            void* stream) {
  Shape sh;
  const BwdParams p = repro_bwd::dq_args(q, k, v, o, dout, lse, delta, dq,
                                         bounds, qseg, kseg, ia, scale, &sh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sh.dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (sh.D == 192 && sh.Dv == 128) return launch_dq<192, 128>(p, sh, s);
  if (sh.D == 160 && sh.Dv == 160) return launch_dq<160, 160>(p, sh, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Kernel D's pair route, bf16: reads delta (written by kernel C or passed
// in), writes dk and dv in one launch.  Returns as kernel C's.
extern "C" int repro_flash_bwd_dkv_pair_sm90(const void* q, const void* k,
                                             const void* v, const void* dout,
                                             const void* lse,
                                             const void* delta, void* dk,
                                             void* dv, const void* bounds,
                                             const void* qbounds,
                                             const void* qseg,
                                             const void* kseg,
                                             const long long* ia, float scale,
                                             void* stream) {
  Shape sh;
  const BwdParams p = repro_bwd::dkv_args(q, k, v, dout, lse, delta, dk, dv,
                                          bounds, qbounds, qseg, kseg, ia,
                                          scale, &sh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sh.dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (sh.D == 192 && sh.Dv == 128) return launch_dkv<192, 128>(p, sh, s);
  if (sh.D == 160 && sh.Dv == 160) return launch_dkv<160, 160>(p, sh, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of kernel C (kernel 0) or D (kernel 1) at head dims
// (dk, dv), in bytes; 0 for a pair the kernels do not take.
extern "C" int repro_flash_bwd_pair_sm90_smem(int kernel, int dk, int dv) {
  if (dk == 192 && dv == 128)
    return static_cast<int>(kernel ? dkv_smem_bytes<192, 128>()
                                   : dq_smem_bytes<192, 128>());
  if (dk == 160 && dv == 160)
    return static_cast<int>(kernel ? dkv_smem_bytes<160, 160>()
                                   : dq_smem_bytes<160, 160>());
  return 0;
}

// Kernel A, bf16 route: the FlashAttention-2 forward of one partial
// attention chunk on Hopper's tensor cores (sm_90a `wgmma`), written by
// hand, with a plain C entry point bound via ctypes.  bf16 is the serving
// and training paths' dtype; float32 inputs take the CUDA-core route
// (flash_fwd.cu).
//
// Replaces the TPU kernel `_fwd_kernel` / `flash_fwd_bhtd` of the JAX
// package (src/repro/kernels/flash_attention.py:157, pallas_call at :252).
//
// Bound on the H100.  Each (row, key) pair the mask allows costs 4·D FLOPs
// (s = q·kᵀ and o += p·v).
//   Training shape (B 1, T 8192, 32 heads of 128, causal): 1.07e9 pairs a
//   call, 0.550 TFLOP over 269 MB of q, k, v, o and lse, about 2,000 FLOP a
//   byte against the card's ridge of 295: operations, 0.556 ms at the bf16
//   tensor-core rate (989 TFLOP/s).
//   Serving shape (one llama-7b prefill chunk: Tq 256 at q_offset 768, Tk
//   1024, 32 heads of 128): 3.76 GFLOP over 21.0 MB, 179 FLOP a byte:
//   bytes, 6.3 us at 3.35 TB/s.
// What the design does about it: both products run on the tensor cores
// with float32 accumulators; every k and v tile is read once per 128 q
// rows and shared by two warpgroups; no score tile leaves the registers;
// the block-sparse table skips every kv tile the mask cannot reach.  p goes
// into the second product as two bf16 terms (see below), which makes that
// product twice as long: 6·D tensor FLOPs a pair, so the least time of
// this design is 1.5× the bound (0.83 ms at the training shape).
//
// Design.  One block per (128-row q tile, query head, batch row), heaviest
// q tiles first (a causal sweep's longest blocks start first): two
// warpgroups (256 threads), warpgroup w owning q rows 64w .. 64w+63.
//   Loads.  The q tile's 128-key tiles [lo, hi] (the wrapper's host table,
//   kernels/block_sparse.kv_block_bounds at 128 × 128) pass through a ring
//   of three shared-memory stages.  Thread 0 requests each k and v tile by
//   TMA, as boxes of 128 rows × 64 columns in the 128-byte-swizzled layout
//   `wgmma` reads (sm90_common.cuh); rows past Tk and D = 32's padding
//   columns arrive as zeros.  Each stage has two `mbarrier`s: `full`
//   (completes when the tile's bytes have landed) and `empty` (every
//   thread arrives once its products no longer read the stage).  Tile
//   n + 2 is requested at the end of pass n, so loads run two passes
//   ahead, and the warpgroups never wait for each other but there.
//   (A separate producer warp or warpgroup, 288 or 384 threads, caps
//   every thread at 168 registers, since an SM sub-partition then holds
//   three warps; `setmaxnreg` did not raise ptxas' allocation, and the
//   consumers, which use 233 registers at D = 128, spilled.)
//   Products.  For each kv tile: s = q·kᵀ as `wgmma` m64n128k16 (both
//   operands in shared memory, K-major), the mask on edge tiles only
//   (outside the table's interior range, or past a ragged Tk), the online
//   softmax in float32 registers in the log2 domain
//   (p = exp2(s·scale·log2 e − m)), l summed from float32 p, then o += p·v
//   with p as the register A operand (m64n128k16 at D = 128, m64n64k16
//   below): the s accumulator's layout is the A fragment layout, so p never
//   leaves the registers.  At the training shape the loads alone take
//   about 0.6 of a call and overlap the softmax; the products add the
//   rest (tools/ablate_flash_fwd.py).
//   p goes in as two bf16 terms, hi = bf16(p) and lo = bf16(p − hi), into
//   one accumulator: with one term a causal chunk misses the element-wise
//   bar (3e-2 of each output) by 7-22×, with two it reads 7e-3 (a CPU
//   emulation of this arithmetic, tests/test_torch_kernels.py).
// NEG_INF handling reproduces the reference's m_safe / alpha rules
// (flash_attention.py:187-206): an empty row gives o = 0 and lse = NEG_INF.
// lse is written in float32, (B, Tq, Hq), for kernels C and D.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_fwd_common.cuh"
#include "sm90_common.cuh"

namespace {

using repro_fwd::FwdParams;
using repro_fwd::Shape;
using repro_fwd::allowed;
using repro_fwd::kNegInf;
using namespace repro_sm90;

constexpr int kRows = 128;    // q rows a block: two warpgroups of 64
constexpr int kKeys = 128;    // keys a kv tile
constexpr int kStages = 3;    // kv tiles in the shared-memory ring
constexpr int kThreads = 256;  // two warpgroups
constexpr float kLn2 = 0.6931471805599453f;

// Bytes of one warpgroup's q slab(s) and of one kv tile (k or v).
template <int D>
__host__ __device__ constexpr uint32_t q_bytes() {
  return slabs<D>() * 64 * 128;
}

template <int D>
__host__ __device__ constexpr uint32_t kv_bytes() {
  return slabs<D>() * kKeys * 128;
}

// Two q slabs, kStages (k, v) pairs, 2·kStages mbarriers, and room to
// align the start to 1024 bytes.
template <int D>
constexpr size_t fwd_sm90_smem_bytes() {
  return 2 * q_bytes<D>() + 2 * kStages * kv_bytes<D>() + 2 * kStages * 8 +
         1024;
}

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

// The 128 threads of warpgroup w (named barrier 1 + w).
__device__ __forceinline__ void wg_sync(int w) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
}

// The largest of this thread's 32 entries of accumulator row r (entries i
// with (i >> 1) & 1 == r), as a tree.
__device__ __forceinline__ float row_max(const float (&s)[64], int r) {
  float t[16];
#pragma unroll
  for (int q = 0; q < 16; ++q)
    t[q] = fmaxf(s[4 * q + 2 * r], s[4 * q + 2 * r + 1]);
#pragma unroll
  for (int q = 0; q < 8; ++q) t[q] = fmaxf(t[q], t[q + 8]);
#pragma unroll
  for (int q = 0; q < 4; ++q) t[q] = fmaxf(t[q], t[q + 4]);
  return fmaxf(fmaxf(t[0], t[2]), fmaxf(t[1], t[3]));
}

// The largest of x over the 4 lanes of a quad (which share a row).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// d (64 × 128, float32) += A · B, both operands in shared memory, K-major.
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db) {
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
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
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

// ---------------------------------------------------------------- kernel A

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma_kernel(const FwdParams a,
                           const __grid_constant__ CUtensorMap tmk,
                           const __grid_constant__ CUtensorMap tmv) {
  constexpr int NC = slabs<D>();
  constexpr int KS = 4 * NC;  // k16 steps over the (padded) head dim
  constexpr uint32_t TQ = q_bytes<D>(), TKV = kv_bytes<D>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t sQ = smem_u32(smem);       // two warpgroups' slabs
  const uint32_t sKV = sQ + 2 * TQ;         // stage s: k at sKV + 2·s·TKV,
                                            //          v TKV after it
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * TQ +
                                               2 * kStages * TKV);
  uint64_t* empty = full + kStages;

  const int h = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y, b = blockIdx.z;
  const int hk = h / a.group;
  const int tid = threadIdx.x;
  const int q0 = qt * kRows;
  const int lo = a.bounds[4 * qt], hi = a.bounds[4 * qt + 1];
  const int ntiles = hi >= lo ? hi - lo + 1 : 0;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int w = tid >> 7, t128 = tid & 127;
  const int warp = t128 >> 5, lane = tid & 31;
  const uint32_t sQw = sQ + w * TQ;

  // Kv tile n (k and v, slab by slab: 128 rows × 64 columns a box, rows
  // past Tk and D = 32's padding columns zero-filled) into stage
  // n % kStages, requested by thread 0.
  auto load_kv = [&](int n) {
    const int s = n % kStages, k0 = (lo + n) * kKeys;
    const uint32_t kt = sKV + 2 * s * TKV;
    mbar_expect_tx(full + s, 2 * TKV);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      tma_load_4d(kt + c * (kKeys * 128), &tmk, 64 * c, hk, k0, b, full + s);
      tma_load_4d(kt + TKV + c * (kKeys * 128), &tmv, 64 * c, hk, k0, b,
                  full + s);
    }
  };
  if (tid == 0)
    for (int n = 0; n < kStages - 1 && n < ntiles; ++n) load_kv(n);

  // the warpgroup's q slab
  {
    const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
    load_tile<D, 64, 128>(sQw, qb, a.q_st, q0 + 64 * w, a.Tq, t128);
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
    wg_sync(w);
  }

  // This thread's accumulator rows (within the warpgroup's 64): rr[0] and
  // rr[1] = rr[0] + 8; its columns in each 8-column group: c0, c0 + 1.
  const int rr[2] = {16 * warp + (lane >> 2), 16 * warp + (lane >> 2) + 8};
  const int c0 = 2 * (lane & 3);
  const float scale2 = a.scale * kLog2e;
  const int ilo = a.bounds[4 * qt + 2], ihi = a.bounds[4 * qt + 3];
  int qp[2], qs[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + 64 * w + rr[r];
    qp[r] = a.q_offset + t;
    qs[r] = a.has_seg && t < a.Tq ? a.qseg[b * a.qs_sb + t] : -1;
  }

  float m[2] = {kNegInf, kNegInf};  // running max, log2 units
  float l[2] = {0.f, 0.f};          // this thread's part of the row sums
  float acc[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;

  for (int n = 0; n < ntiles; ++n) {
    const int s = n % kStages;
    const int j = lo + n, k0 = j * kKeys;
    const uint32_t kt = sKV + 2 * s * TKV, vt = kt + TKV;
    mbar_wait(full + s, (n / kStages) & 1);

    float sc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      mma_ss_n128(sc, kmajor<64>(sQw, ks), kmajor<kKeys>(kt, ks));
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);

    // scale into log2 units, then mask (edge tiles only)
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] *= scale2;
    const bool edge = (a.masked && (j < ilo || j > ihi)) || k0 + kKeys > a.Tk;
    if (edge) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int r = (i >> 1) & 1;
        const int col = 8 * (i >> 2) + c0 + (i & 1);
        const int kl = k0 + col;
        if (!(kl < a.Tk &&
              allowed(a, qp[r], a.kv_offset + kl, qs[r],
                      a.has_seg ? a.kseg[b * a.ks_sb + kl] : 0)))
          sc[i] = kNegInf;
      }
    }

    // online softmax; the 4 lanes of a quad share a row
    float alpha[2], mb[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mx = quad_max(row_max(sc, r));
      const float m_new = fmaxf(m[r], mx);
      // exactly 1 where the max stands, so a tile the row cannot see
      // (the dense sweep's) changes nothing
      alpha[r] = m[r] <= kNegInf * 0.5f ? 0.f
                 : m[r] == m_new        ? 1.f
                                        : exp2_approx(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
      // a row with nothing to see yet subtracts 0: its masked scores
      // still give exactly 0
      mb[r] = m_new <= kNegInf * 0.5f ? 0.f : m_new;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = exp2_approx(sc[i] - mb[r]);
      l[r] += sc[i];
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] *= alpha[(i >> 1) & 1];

    // p as two bf16 terms, hi + lo: the A fragments of o += p·v, 16 keys a
    // k16 step (the accumulator layout of s is the A fragment layout)
    uint32_t ph[8][4], pl[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int i = 8 * kk + 2 * f;
        const __nv_bfloat162 hv = __floats2bfloat162_rn(sc[i], sc[i + 1]);
        const float2 hf = __bfloat1622float2(hv);
        ph[kk][f] = *reinterpret_cast<const uint32_t*>(&hv);
        pl[kk][f] = pack_bf16(sc[i] - hf.x, sc[i + 1] - hf.y);
      }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      if constexpr (NC == 2) {  // D = 128: one n128 product a term
        const uint64_t dv = sw128_desc(vt + kk * 2048, kKeys * 128, 1024);
        mma_rs_n128(acc[0], acc[NC - 1], ph[kk], dv);
        mma_rs_n128(acc[0], acc[NC - 1], pl[kk], dv);
      } else {
        mma_rs(acc[0], ph[kk], mnmajor<kKeys>(vt, 0, kk));
        mma_rs(acc[0], pl[kk], mnmajor<kKeys>(vt, 0, kk));
      }
    }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      fence_regs(ph[kk]);
      fence_regs(pl[kk]);
    }
    mbar_arrive(empty + s);  // this thread no longer reads stage s

    // Request tile n + kStages − 1 into the stage tile n − 1 used, once
    // both warpgroups have released it (the other is at most half a pass
    // behind).
    if (tid == 0 && n + kStages - 1 < ntiles) {
      if (n >= 1) mbar_wait(empty + (n - 1) % kStages, ((n - 1) / kStages) & 1);
      load_kv(n + kStages - 1);
    }
  }

  // o = acc / l and lse = m + log l, both rows of this thread
  bf16* ob = static_cast<bf16*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv = lt == 0.f ? 1.f : 1.f / lt;
    const int t = q0 + 64 * w + rr[r];
    if (t >= a.Tq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 2 * r; i < 32; i += 4) {
        const int col = 64 * c + 8 * (i >> 2) + c0;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(ob + t * a.o_st + col) =
              __floats2bfloat162_rn(acc[c][i] * inv, acc[c][i + 1] * inv);
      }
    if ((lane & 3) == 0)
      a.lse[((long long)b * a.Tq + t) * a.Hq + h] =
          lt == 0.f ? kNegInf : m[r] * kLn2 + logf(lt);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's tensor-map encoder, looked up once through the runtime (the
// library links no driver library of its own).
EncodeTiled encoder() {
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

// The TMA map of one (B, T, Hkv, D) bf16 tensor with element strides sb,
// st, sh, as the 4-d tensor (D, Hkv, T, B): boxes of 64 columns × 1 head ×
// 128 rows × 1, 128-byte swizzled, out-of-bounds elements read as zero.  A
// dimension of extent 1 gets a stride that follows from the one before
// (its own is never used).  Returns the CUresult.
int kv_map(CUtensorMap* m, const void* base, int D, int Hkv, int T, int B,
           long long sh, long long st, long long sb) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(CUDA_ERROR_NOT_FOUND);
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                        static_cast<cuuint64_t>(Hkv),
                        static_cast<cuuint64_t>(T),
                        static_cast<cuuint64_t>(B)};
  const long long el[3] = {sh, st, sb};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = dims[i + 1] > 1 ? static_cast<cuuint64_t>(2 * el[i])
                 : i == 0        ? 2 * dims[0]
                                 : strides[i - 1] * dims[i];
  cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(kKeys), 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  return static_cast<int>(enc(
      m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// Launches the kernel; returns the CUDA error of the launch, or 1000 plus
// the CUresult when a tensor map cannot be encoded.
template <int D>
int launch(const FwdParams& p, int nq, int B, cudaStream_t s) {
  CUtensorMap mk, mv;
  const int Hkv = p.Hq / p.group;
  int r = kv_map(&mk, p.k, D, Hkv, p.Tk, B, p.k_sh, p.k_st, p.k_sb);
  if (r == 0) r = kv_map(&mv, p.v, D, Hkv, p.Tk, B, p.v_sh, p.v_st, p.v_sb);
  if (r != 0) return 1000 + r;
  const size_t smem = fwd_sm90_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_fwd_wgmma_kernel<D><<<dim3(p.Hq, nq, B), kThreads, smem, s>>>(p, mk,
                                                                     mv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Kernel A, bf16 (ia's dtype must be 1); ia as in flash_fwd_common.cuh,
// with nq and the bounds table in 128-row q tiles of 128-key kv tiles.
// Returns 0 when launched, else the CUDA error of the launch, or 1000 plus
// the CUresult of a tensor map that could not be encoded.
extern "C" int repro_flash_fwd_sm90(const void* q, const void* k,
                                    const void* v, void* o, void* lse,
                                    const void* bounds, const void* qseg,
                                    const void* kseg, const long long* ia,
                                    float scale, void* stream) {
  Shape sh;
  const FwdParams p = repro_fwd::parse(q, k, v, o, lse, bounds, qseg, kseg,
                                       ia, scale, &sh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sh.dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (sh.D) {
    case 32: return launch<32>(p, sh.nq, sh.B, s);
    case 64: return launch<64>(p, sh.nq, sh.B, s);
    case 128: return launch<128>(p, sh.nq, sh.B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of the kernel at head dim d, in bytes; 0 for a
// head dim it does not take.
extern "C" int repro_flash_fwd_sm90_smem(int d) {
  switch (d) {
    case 32: return static_cast<int>(fwd_sm90_smem_bytes<32>());
    case 64: return static_cast<int>(fwd_sm90_smem_bytes<64>());
    case 128: return static_cast<int>(fwd_sm90_smem_bytes<128>());
    default: return 0;
  }
}

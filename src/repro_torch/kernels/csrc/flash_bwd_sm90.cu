// Kernels C and D, bf16 route: the FlashAttention-2 backward of one partial
// attention chunk on Hopper's tensor cores (sm_90a `wgmma`), written by
// hand, with plain C entry points bound via ctypes.  bf16 is the training
// path's dtype; float32 inputs take the CUDA-core route (flash_bwd.cu).
// One head dim D (32, 64, 128) for q, k and v; materialised MLA's q/k 192,
// v 128 takes flash_bwd_pair_sm90.cu.
//
// Replaces the TPU kernels of the JAX package's `flash_bwd_bhtd`
// (src/repro/kernels/flash_attention.py) for bf16:
//   C `_dq_kernel`  (:280, pallas_call at :417) -> flash_bwd_dq_wgmma_kernel
//   D `_dkv_kernel` (:322, pallas_call at :450) -> flash_bwd_dkv_wgmma_kernel
//
// Bound on the H100: operations.  One llama-7b attention backward (B 1,
// T 8192, 32 heads of 128, causal) has 1.07e9 unmasked (row, key) pairs.
// C does 6·D FLOPs per pair (s = q·kᵀ, dp = do·vᵀ, dq += ds·k), D does 8·D
// (s, dp, dv += pᵀ·do, dk += dsᵀ·q): 0.82 and 1.10 TFLOP over 0.40 GB each,
// some 2,000 FLOP per byte against the card's ridge of 295, so the least
// times are the bf16 tensor-core rate's (989 TFLOP/s) 0.83 and 1.11 ms.
//
// Design.  One warpgroup (128 threads) per block and two blocks per SM;
// every product is `wgmma.mma_async.m64n64k16` with bf16 operands and
// float32 accumulators in registers.
//   Shared memory.  Tiles stay bf16, in the 128-byte-swizzled layout the
//   wgmma operand descriptors read: a 64-row tile of head dim D is D/64
//   slabs of 64 rows × 64 columns (D = 32 is zero-padded to one slab), and
//   16-byte group g of row r sits at g ^ (r % 8).  16-byte `cp.async`
//   copies fill them, double-buffered: the next kv tile (C) or q tile with
//   its lse, delta and segments (D) lands while the current one computes.
//   At D = 128 a block holds 6 tiles, 96 KB.
//   C: one block per (64-row q tile, query head, batch row), heaviest q
//      tiles first.  Its q and do tiles stay resident while it sweeps the
//      tile's valid 64-key tiles [lo, hi] (the forward's host table,
//      kernels/block_sparse.kv_block_bounds).  s = q·kᵀ and dp = do·vᵀ take
//      both operands from shared memory (K-major, as (B, T, H, D) lays them
//      out); p = exp2(s·scale·log2 e − lse·log2 e) and ds = p·(dp − delta)·
//      scale stay in float32 registers, and ds, in bf16, is the register A
//      operand of dq += ds·k, with k read as an MN-major B operand (the
//      transpose bit).  ds goes in as two bf16 terms (hi and the rounding
//      remainder lo): a row's ds sums to zero over its keys, and one bf16
//      term would let the keys' common component into dq.  delta =
//      rowsum(o ⊙ do) is computed in the prologue (float32, 16-byte loads)
//      and written for D, unless the caller passed it.
//   D: one block per (64-key kv tile, kv head, batch row).  k and v stay
//      resident; the block sweeps every query head of its GQA group and,
//      for each, the valid q tiles of the transposed host table
//      (kernels/block_sparse.q_block_bounds).  It computes sᵀ = k·qᵀ and
//      dpᵀ = v·doᵀ directly, so pᵀ and dsᵀ are accumulators already and
//      become, in bf16, the register A operands of dv += pᵀ·do and
//      dk += dsᵀ·q.  dk and dv (64 + 64 registers a thread at D = 128)
//      are summed over the group on chip and written once.  With sᵀ and
//      dpᵀ they fill the 255 registers a thread that two blocks an SM
//      allow, without spilling (chip_smoke.py's build phase checks it).
//   The kernels are templated on <DK, DV>, the head dims of q / k and of
//   v, instantiated at <D, D>.
//   No p or ds tile goes through shared or device memory, and there are
//   no atomics: each run gives the same bits.  The element-wise mask runs
//   on edge tiles only (outside the table's interior range, or past a
//   ragged Tq / Tk edge); a row whose lse is NEG_INF gives p = 0.  D rounds
//   p and ds to bf16 before its second products, as any tensor-core
//   backward does, so the results are held to a per-row relative bar
//   (kernels/ref.row_rel_err) rather than an element-wise one.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd_common.cuh"
#include "sm90_common.cuh"

namespace {

using repro_bwd::BwdParams;
using repro_bwd::Shape;
using repro_bwd::allowed;
using repro_bwd::kNegInf;
using namespace repro_sm90;

constexpr int kTile = 64;        // q rows and keys per tile
constexpr int kThreads = 128;    // one warpgroup a block
constexpr int kSlab = 64 * 128;  // bytes of a 64-row × 64-column bf16 slab

__device__ __forceinline__ float dot8(const uint4& x, const uint4& y,
                                      float acc) {
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fa = __bfloat1622float2(a[i]);
    const float2 fb = __bfloat1622float2(b[i]);
    acc = fmaf(fa.x, fb.x, acc);
    acc = fmaf(fa.y, fb.y, acc);
  }
  return acc;
}

// Each block holds one q / k-sized and one do / v-sized tile, and two
// buffers of each of the other pair: 3 tiles of each size.
// x, opaque to the compiler: a resident tile's address read through it in
// each sweep step keeps the step's operand descriptors (2 registers each)
// from being hoisted out of the loop and held in registers across it;
// recomputing them is a few integer adds.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

template <int DK, int DV>
constexpr size_t dq_smem_bytes() {
  return 3 * (slabs<DK>() + slabs<DV>()) * kSlab + 5 * kTile * 4 + 1024;
}

template <int DK, int DV>
constexpr size_t dkv_smem_bytes() {
  return 3 * (slabs<DK>() + slabs<DV>()) * kSlab + 7 * kTile * 4 + 1024;
}

// ---------------------------------------------------------------- kernel C

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dq_wgmma_kernel(const BwdParams a) {
  constexpr int NC = slabs<DK>();        // dq's 64-column slabs
  constexpr int KS = 4 * NC;             // k16 steps over q·kᵀ's depth
  constexpr int KSV = 4 * slabs<DV>();   // k16 steps over do·vᵀ's depth
  constexpr uint32_t TK = NC * kSlab;              // bytes of a q / k tile
  constexpr uint32_t TV = slabs<DV>() * kSlab;     // of a do / v tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t sQ = smem_u32(smem), sDO = sQ + TK;
  const uint32_t sK = sDO + TV, sV = sK + 2 * TK;  // two buffers each
  float* sL = reinterpret_cast<float*>(smem + 3 * (TK + TV));
  float* sDl = sL + kTile;
  int* sQs = reinterpret_cast<int*>(sDl + kTile);
  int* sKs = sQs + kTile;  // two buffers

  const int h = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y, b = blockIdx.z;
  const int hk = h / a.group;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = qt * kTile;
  const int lo = a.bounds[4 * qt], hi = a.bounds[4 * qt + 1];
  const int ilo = a.bounds[4 * qt + 2], ihi = a.bounds[4 * qt + 3];

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* dob =
      static_cast<const bf16*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh;

  auto load_kv = [&](int j, int buf) {
    load_tile<DK, kTile, kThreads>(sK + buf * TK, kb, a.k_st, j * kTile,
                                   a.Tk, threadIdx.x);
    load_tile<DV, kTile, kThreads>(sV + buf * TV, vb, a.v_st, j * kTile,
                                   a.Tk, threadIdx.x);
    if (a.has_seg && tid < kTile) {
      const int t = j * kTile + tid;
      cp_async4(sKs + buf * kTile + tid,
                a.kseg + b * a.ks_sb + (t < a.Tk ? t : 0), t < a.Tk);
    }
  };

  load_tile<DK, kTile, kThreads>(sQ, qb, a.q_st, q0, a.Tq, threadIdx.x);
  load_tile<DV, kTile, kThreads>(sDO, dob, a.do_st, q0, a.Tq,
                                 threadIdx.x);
  cp_async_commit();
  if (lo <= hi) load_kv(lo, 0);
  cp_async_commit();

  if (tid < kTile) {
    const int t = q0 + tid;
    const long long si = ((long long)b * a.Tq + t) * a.Hq + h;
    sL[tid] = t < a.Tq ? a.lse[si] : kNegInf;
    if (!a.compute_delta) sDl[tid] = t < a.Tq ? a.delta[si] : 0.f;
    if (a.has_seg) sQs[tid] = t < a.Tq ? a.qseg[b * a.qs_sb + t] : -1;
  }
  if (a.compute_delta) {  // delta = rowsum(o ⊙ do): two threads per row
    const bf16* ob = static_cast<const bf16*>(a.o) + b * a.o_sb + h * a.o_sh;
    const int row = tid >> 1, half = tid & 1;
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
  }
  __syncthreads();

  // This thread's accumulator rows: rr[0] and rr[1] = rr[0] + 8.
  const int rr[2] = {16 * warp + (lane >> 2), 16 * warp + (lane >> 2) + 8};
  const int c0 = 2 * (lane & 3);
  const float scale2 = a.scale * kLog2e;
  float Ls[2], Dl[2];
  bool live[2];
  int qs[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float L = sL[rr[r]];
    live[r] = L > kNegInf * 0.5f;
    Ls[r] = L * kLog2e;
    Dl[r] = sDl[rr[r]];
    qs[r] = a.has_seg ? sQs[rr[r]] : 0;
  }

  float acc[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;

  for (int j = lo; j <= hi; ++j) {
    const int buf = (j - lo) & 1;
    if (j < hi) load_kv(j + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the tile just requested
    fence_proxy_async();
    __syncthreads();
    const uint32_t kt = sK + buf * TK, vt = sV + buf * TV;
    const uint32_t q_at = opaque(sQ), g_at = opaque(sDO);

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      mma_ss(s, kmajor<kTile>(q_at, ks), kmajor<kTile>(kt, ks));
    wg_commit();
#pragma unroll
    for (int ks = 0; ks < KSV; ++ks)
      mma_ss(dp, kmajor<kTile>(g_at, ks), kmajor<kTile>(vt, ks));
    wg_commit();
    wg_wait<1>();
    fence_regs(s);

    // p = exp(s·scale − lse), masked on edge tiles; dp is still in flight
    const int k0 = j * kTile;
    const bool edge = (a.masked && (j < ilo || j > ihi)) || k0 + kTile > a.Tk;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      bool ok = live[r];
      if (edge) {
        const int col = 8 * (i >> 2) + c0 + (i & 1);
        const int kl = k0 + col;
        ok = ok && kl < a.Tk &&
             allowed(a, a.q_offset + q0 + rr[r], a.kv_offset + kl, qs[r],
                     a.has_seg ? sKs[buf * kTile + col] : 0);
      }
      s[i] = ok ? exp2_approx(fmaf(s[i], scale2, -Ls[r])) : 0.f;
    }
    wg_wait<0>();
    fence_regs(dp);

    // ds = p·(dp − delta)·scale as two bf16 terms, hi + lo: the A
    // fragments of dq += ds·k.  A row's ds sums to zero over its keys, and
    // dq is what is left of k after that cancellation; one bf16 term alone
    // would break the zero sum by ~2^-9 of |ds| and let the keys' common
    // component into dq.  The lo term doubles this product.
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int i = 8 * kk + 2 * f;
        const float d = Dl[f & 1];
        const float x0 = s[i] * (dp[i] - d) * a.scale;
        const float x1 = s[i + 1] * (dp[i + 1] - d) * a.scale;
        const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
        const float2 hf = __bfloat1622float2(h);
        ah[kk][f] = *reinterpret_cast<const uint32_t*>(&h);
        al[kk][f] = pack_bf16(x0 - hf.x, x1 - hf.y);
      }
    wg_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        mma_rs(acc[c], ah[kk], mnmajor<kTile>(kt, c, kk));
        mma_rs(acc[c], al[kk], mnmajor<kTile>(kt, c, kk));
      }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(ah[kk]);
      fence_regs(al[kk]);
    }
    __syncthreads();  // the buffer is free for the tile after next
  }
  cp_async_wait<0>();

  bf16* out = static_cast<bf16*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int t = q0 + rr[(i >> 1) & 1];
      const int col = 64 * c + 8 * (i >> 2) + c0;
      if (t < a.Tq && col < DK)
        *reinterpret_cast<__nv_bfloat162*>(out + t * a.dq_st + col) =
            __floats2bfloat162_rn(acc[c][i], acc[c][i + 1]);
    }
}

// ---------------------------------------------------------------- kernel D

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dkv_wgmma_kernel(const BwdParams a) {
  constexpr int NC = slabs<DK>();        // dk's 64-column slabs
  constexpr int NCV = slabs<DV>();       // dv's
  constexpr int KS = 4 * NC;
  constexpr int KSV = 4 * NCV;
  constexpr uint32_t TK = NC * kSlab, TV = NCV * kSlab;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t sK = smem_u32(smem), sV = sK + TK;
  const uint32_t sQ = sV + TV, sDO = sQ + 2 * TK;  // two buffers each
  float* sL = reinterpret_cast<float*>(smem + 3 * (TK + TV));  // two buffers
  float* sDl = sL + 2 * kTile;                            // two buffers
  int* sQs = reinterpret_cast<int*>(sDl + 2 * kTile);     // two buffers
  int* sKs = sQs + 2 * kTile;

  const int hk = blockIdx.x, kt = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = kt * kTile;
  const int qlo = a.qbounds[2 * kt], qhi = a.qbounds[2 * kt + 1];
  const int nqt = qhi >= qlo ? qhi - qlo + 1 : 0;
  const int items = nqt * a.group;  // (query head, q tile) pairs to sweep

  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh;

  auto load_q = [&](int n, int buf) {
    const int h = hk * a.group + n / nqt;
    const int q0 = (qlo + n % nqt) * kTile;
    load_tile<DK, kTile, kThreads>(sQ + buf * TK,
                 static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh,
                 a.q_st, q0, a.Tq, threadIdx.x);
    load_tile<DV, kTile, kThreads>(sDO + buf * TV,
                 static_cast<const bf16*>(a.dout) + b * a.do_sb + h * a.do_sh,
                 a.do_st, q0, a.Tq, threadIdx.x);
    if (tid < kTile) {
      const int t = q0 + tid;
      const bool ok = t < a.Tq;
      const long long si = ((long long)b * a.Tq + (ok ? t : 0)) * a.Hq + h;
      cp_async4(sL + buf * kTile + tid, a.lse + si, ok);
      cp_async4(sDl + buf * kTile + tid, a.delta + si, ok);
      if (a.has_seg)
        cp_async4(sQs + buf * kTile + tid,
                  a.qseg + b * a.qs_sb + (ok ? t : 0), ok);
    }
  };

  load_tile<DK, kTile, kThreads>(sK, kb, a.k_st, k0, a.Tk, threadIdx.x);
  load_tile<DV, kTile, kThreads>(sV, vb, a.v_st, k0, a.Tk, threadIdx.x);
  if (a.has_seg && tid < kTile) {
    const bool ok = k0 + tid < a.Tk;
    cp_async4(sKs + tid, a.kseg + b * a.ks_sb + (ok ? k0 + tid : 0), ok);
  }
  cp_async_commit();
  if (items > 0) load_q(0, 0);
  cp_async_commit();

  // This thread's accumulator rows are keys kr[0] and kr[1] = kr[0] + 8.
  const int kr[2] = {16 * warp + (lane >> 2), 16 * warp + (lane >> 2) + 8};
  const int c0 = 2 * (lane & 3);
  const float scale2 = a.scale * kLog2e;

  float dk[NC][32], dv[NCV][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[c][i] = 0.f;
#pragma unroll
  for (int c = 0; c < NCV; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dv[c][i] = 0.f;

  for (int n = 0; n < items; ++n) {
    const int buf = n & 1;
    const int qi = qlo + n % nqt;
    const int q0 = qi * kTile;
    if (n + 1 < items) load_q(n + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    const uint32_t qt = sQ + buf * TK, gt = sDO + buf * TV;
    const uint32_t k_at = opaque(sK), v_at = opaque(sV);
    const float* L = sL + buf * kTile;
    const float* Dl = sDl + buf * kTile;
    const int* Qs = sQs + buf * kTile;

    float st[32], dpt[32];  // sᵀ and dpᵀ: rows are keys, columns q rows
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      mma_ss(st, kmajor<kTile>(k_at, ks), kmajor<kTile>(qt, ks));
    wg_commit();
#pragma unroll
    for (int ks = 0; ks < KSV; ++ks)
      mma_ss(dpt, kmajor<kTile>(v_at, ks), kmajor<kTile>(gt, ks));
    wg_commit();
    wg_wait<1>();
    fence_regs(st);

    // interior tiles (every pair attends) come from the forward's table
    const bool edge =
        (a.masked && (kt < a.bounds[4 * qi + 2] || kt > a.bounds[4 * qi + 3]))
        || k0 + kTile > a.Tk;
    const bool qedge = q0 + kTile > a.Tq;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const int col = 8 * (i >> 2) + c0 + (i & 1);
      const float Lq = L[col];
      bool ok = Lq > kNegInf * 0.5f && (!qedge || q0 + col < a.Tq);
      if (edge) {
        const int kl = k0 + kr[r];
        ok = ok && kl < a.Tk &&
             allowed(a, a.q_offset + q0 + col, a.kv_offset + kl,
                     a.has_seg ? Qs[col] : 0, a.has_seg ? sKs[kr[r]] : 0);
      }
      st[i] = ok ? exp2_approx(fmaf(st[i], scale2, -Lq * kLog2e)) : 0.f;
    }
    wg_wait<0>();
    fence_regs(dpt);

    // pᵀ and dsᵀ = pᵀ·(dpᵀ − delta)·scale in bf16: the A fragments of
    // dv += pᵀ·do and dk += dsᵀ·q
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int i = 8 * kk + 2 * f;
        pa[kk][f] = pack_bf16(st[i], st[i + 1]);
        const float2 d =
            *reinterpret_cast<const float2*>(Dl + 8 * (i >> 2) + c0);
        da[kk][f] = pack_bf16(st[i] * (dpt[i] - d.x) * a.scale,
                              st[i + 1] * (dpt[i + 1] - d.y) * a.scale);
      }
    wg_fence();
#pragma unroll
    for (int c = 0; c < NCV; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs(dv[c], pa[kk], mnmajor<kTile>(gt, c, kk));
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs(dk[c], da[kk], mnmajor<kTile>(qt, c, kk));
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(dk[c]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(da[kk]);
#pragma unroll
    for (int c = 0; c < NCV; ++c) fence_regs(dv[c]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
    __syncthreads();  // the buffers are free for the item after next
  }
  cp_async_wait<0>();

  bf16* ko = static_cast<bf16*>(a.dk) + b * a.dk_sb + hk * a.dk_sh;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int t = k0 + kr[(i >> 1) & 1];
      const int col = 64 * c + 8 * (i >> 2) + c0;
      if (t < a.Tk && col < DK)
        *reinterpret_cast<__nv_bfloat162*>(ko + t * a.dk_st + col) =
            __floats2bfloat162_rn(dk[c][i], dk[c][i + 1]);
    }
  bf16* vo = static_cast<bf16*>(a.dv) + b * a.dv_sb + hk * a.dv_sh;
#pragma unroll
  for (int c = 0; c < NCV; ++c)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int t = k0 + kr[(i >> 1) & 1];
      const int col = 64 * c + 8 * (i >> 2) + c0;
      if (t < a.Tk && col < DV)
        *reinterpret_cast<__nv_bfloat162*>(vo + t * a.dv_st + col) =
            __floats2bfloat162_rn(dv[c][i], dv[c][i + 1]);
    }
}

// ---------------------------------------------------------------- launch

template <int DK, int DV>
cudaError_t launch_dq(const BwdParams& p, int nq, int B, cudaStream_t s) {
  const size_t smem = dq_smem_bytes<DK, DV>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<DK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  flash_bwd_dq_wgmma_kernel<DK, DV>
      <<<dim3(p.Hq, nq, B), kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <int DK, int DV>
cudaError_t launch_dkv(const BwdParams& p, int nk, int Hkv, int B,
                       cudaStream_t s) {
  const size_t smem = dkv_smem_bytes<DK, DV>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma_kernel<DK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  flash_bwd_dkv_wgmma_kernel<DK, DV>
      <<<dim3(Hkv, nk, B), kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Kernel C, bf16.  Writes dq and, when compute_delta, delta.  Returns the
// CUDA error code of the launch (0 = launched).
extern "C" int repro_flash_bwd_dq_sm90(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* dout, const void* lse,
                                       void* delta, void* dq,
                                       const void* bounds, const void* qseg,
                                       const void* kseg, const long long* ia,
                                       float scale, void* stream) {
  Shape sh;
  const BwdParams p = repro_bwd::dq_args(q, k, v, o, dout, lse, delta, dq,
                                         bounds, qseg, kseg, ia, scale, &sh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sh.dtype != 1 || sh.Dv != sh.D)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (sh.D) {
    case 32: return static_cast<int>(launch_dq<32, 32>(p, sh.nq, sh.B, s));
    case 64: return static_cast<int>(launch_dq<64, 64>(p, sh.nq, sh.B, s));
    case 128:
      return static_cast<int>(launch_dq<128, 128>(p, sh.nq, sh.B, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Kernel D, bf16.  Reads delta (written by kernel C or passed in); writes
// dk and dv.  Returns the CUDA error code of the launch (0 = launched).
extern "C" int repro_flash_bwd_dkv_sm90(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const void* lse, const void* delta,
                                        void* dk, void* dv,
                                        const void* bounds,
                                        const void* qbounds,
                                        const void* qseg, const void* kseg,
                                        const long long* ia, float scale,
                                        void* stream) {
  Shape sh;
  const BwdParams p = repro_bwd::dkv_args(q, k, v, dout, lse, delta, dk, dv,
                                          bounds, qbounds, qseg, kseg, ia,
                                          scale, &sh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sh.dtype != 1 || sh.Dv != sh.D)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (sh.D) {
    case 32:
      return static_cast<int>(
          launch_dkv<32, 32>(p, sh.nk, sh.Hkv, sh.B, s));
    case 64:
      return static_cast<int>(
          launch_dkv<64, 64>(p, sh.nk, sh.Hkv, sh.B, s));
    case 128:
      return static_cast<int>(
          launch_dkv<128, 128>(p, sh.nk, sh.Hkv, sh.B, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of kernel C (kernel 0) or D (kernel 1) at head dims
// (dk, dv), in bytes; 0 for a pair the kernels do not take.
extern "C" int repro_flash_bwd_sm90_smem(int kernel, int dk, int dv) {
  if (dk != dv) return 0;
  switch (dk) {
    case 32: return static_cast<int>(kernel ? dkv_smem_bytes<32, 32>()
                                            : dq_smem_bytes<32, 32>());
    case 64: return static_cast<int>(kernel ? dkv_smem_bytes<64, 64>()
                                            : dq_smem_bytes<64, 64>());
    case 128: return static_cast<int>(kernel ? dkv_smem_bytes<128, 128>()
                                             : dq_smem_bytes<128, 128>());
    default: return 0;
  }
}

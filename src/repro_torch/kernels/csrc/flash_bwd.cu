// Kernels C and D, float32 route: the FlashAttention-2 backward of one
// partial attention chunk for float32 inputs, written by hand for Hopper
// (sm_90a), with plain C entry points bound via ctypes.  bf16 inputs, the
// training path's dtype, take the tensor-core route (flash_bwd_sm90.cu);
// this file keeps IEEE float32 FMAs on the CUDA cores, which the float32
// parity bar (2e-4, no TF32) needs.  Together with kernel A
// (flash_fwd.cu) the pair is the complete gradient of a chunk: from the
// saved (o, lse) it gives dq, dk and dv, and never reruns the forward.
//
// Replaces the TPU kernels of the JAX package's `flash_bwd_bhtd`
// (src/repro/kernels/flash_attention.py) for float32:
//   C `_dq_kernel`  (:280, pallas_call at :417) -> flash_bwd_dq_kernel
//   D `_dkv_kernel` (:322, pallas_call at :450) -> flash_bwd_dkv_kernel
//
// Bound on the H100: operations.  C does 6·D FLOPs per unmasked (row, key)
// pair (s = q·kᵀ, dp = do·vᵀ, dq += ds·k) and D does 8·D (s, dp, dv += pᵀ·do,
// dk += dsᵀ·q) — 2·(2·Dk + Dv) and 2·(2·Dk + 2·Dv) when v's head dim Dv
// differs from q's and k's Dk — some 2,000 FLOP per byte at T 8192, far
// above the card's ridge; in float32 outside the tensor cores the ceiling
// is 67 TFLOP/s.
// What the design does about the bound: no score, probability or ds tile
// reaches device memory; the host tables skip every tile the mask cannot
// reach (half of them, causally); the element-wise mask runs only on edge
// tiles; and D sums dk and dv over the GQA group on chip, so nothing is
// reduced in device memory afterwards.
//
// Design.
//   C: one block (256 threads) per (64-row q tile, query head, batch row).
//      The q and do tiles, lse and delta stay in shared memory while the
//      block loops over the tile's valid 64-key tiles [lo, hi] from the
//      forward's host table (kernels/block_sparse.kv_block_bounds).  The
//      dq accumulator lives in registers: thread (rg, cl) owns rows
//      4·rg..4·rg+3 and columns cl + 16·j, and writes them once.
//      delta = rowsum(o ⊙ do) is computed in C's prologue (one warp per
//      row, o read once) and written for D, unless the caller passed it.
//   D: one block per (64-key kv tile, kv head, batch row).  The k and v
//      tiles stay in shared memory; the block loops over the query heads
//      of its GQA group and, for each, over the valid q tiles [lo, hi] of
//      the transposed host table (kernels/block_sparse.q_block_bounds).
//      dk and dv accumulate in registers (thread (rg, cl) owns keys
//      4·rg..4·rg+3 and columns cl + 16·j) and are written once: no
//      atomics, so the result is the same from run to run.
// Tensors are read in the model's (B, T, H, D) layout through strides.
// Ragged Tq and Tk are masked at the edge: missing q rows carry lse =
// NEG_INF, missing keys are masked.  A row whose lse is NEG_INF (nothing to
// attend) gives p = 0, as the reference's `lse <= NEG_INF / 2` rule.
// The kernels are templated on <DK, DV>, the head dims of q / k and of v
// (the reference's kernels take Dv != Dk): one head dim D of 32, 64, 128 or
// 160 (zamba2's shared attention block) is <D, D>; materialised MLA
// (deepseek-v2-lite-16b's training path) is <192, 128>, where v may be a
// strided view (read through its strides).  Shared memory at D = 128 is
// 150 KB (C) and 166 KB (D), at 192 / 128 183 KB and 199 KB, at 160 183 KB
// and 199 KB, above the 48 KB default, so each launch raises the
// kernel's dynamic shared-memory limit.
#include <cuda_runtime.h>

#include "flash_bwd_common.cuh"

namespace {

using repro_bwd::BwdParams;
using repro_bwd::Shape;
using repro_bwd::allowed;
using repro_bwd::kNegInf;

constexpr int BR = 64;   // q rows per tile
constexpr int BC = 64;   // keys per tile
constexpr int NT = 256;  // threads per block

template <int DK, int DV>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (BR * (DK + 1) + BR * (DV + 1) + BC * (DK + 1) +
                          BC * (DV + 1) + BR * (BC + 1) + 2 * BR) +
         sizeof(int) * (BR + BC);
}

template <int DK, int DV>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (BC * (DK + 1) + BC * (DV + 1) + BR * (DK + 1) +
                          BR * (DV + 1) + 2 * BC * (BR + 1) + 2 * BR) +
         sizeof(int) * (BR + BC);
}

// Loads rows [t0, t0 + 64) of one head of a (B, T, H, D) tensor into a
// padded float tile; rows at or past T read as 0.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          long long st, int t0, int T_len) {
  constexpr int DP = D + 1;
  for (int idx = threadIdx.x; idx < 64 * D; idx += NT) {
    const int i = idx / D, d = idx - i * D;
    const int t = t0 + i;
    dst[i * DP + d] = t < T_len ? base[t * st + d] : 0.f;
  }
}

// ---------------------------------------------------------------- kernel C

template <int DK, int DV>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(BwdParams a) {
  constexpr int DPK = DK + 1;  // padded row of a q or k tile
  constexpr int DPV = DV + 1;  // padded row of a do or v tile
  constexpr int DM = DK < DV ? DK : DV;
  constexpr int PP = BC + 1;
  constexpr int NCK = DK / 16;  // dq columns a thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + BR * DPK;
  float* sK = sDO + BR * DPV;
  float* sV = sK + BC * DPK;
  float* sS = sV + BC * DPV;  // ds tile
  float* sL = sS + BR * PP;
  float* sDl = sL + BR;
  int* sQs = reinterpret_cast<int*>(sDl + BR);
  int* sKs = sQs + BR;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.group;
  const int tid = threadIdx.x;
  const int rg = tid >> 4;
  const int cl = tid & 15;
  const int q0 = qt * BR;
  const int lo = a.bounds[4 * qt], hi = a.bounds[4 * qt + 1];
  const int ilo = a.bounds[4 * qt + 2], ihi = a.bounds[4 * qt + 3];

  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* dob =
      static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;

  load_tile<DK>(sQ, qb, a.q_st, q0, a.Tq);
  load_tile<DV>(sDO, dob, a.do_st, q0, a.Tq);
  if (tid < BR) {
    const int t = q0 + tid;
    const long long si = ((long long)b * a.Tq + t) * a.Hq + h;
    sL[tid] = t < a.Tq ? a.lse[si] : kNegInf;
    if (!a.compute_delta) sDl[tid] = t < a.Tq ? a.delta[si] : 0.f;
    if (a.has_seg) sQs[tid] = t < a.Tq ? a.qseg[b * a.qs_sb + t] : -1;
  }
  if (a.compute_delta) {  // delta = rowsum(o ⊙ do): one warp per row
    __syncthreads();
    const float* ob =
        static_cast<const float*>(a.o) + b * a.o_sb + h * a.o_sh;
    const int warp = tid >> 5, lane = tid & 31;
    for (int i = warp; i < BR; i += NT / 32) {
      const int t = q0 + i;
      float acc = 0.f;
      if (t < a.Tq)
        for (int d = lane; d < DV; d += 32)
          acc = fmaf(ob[t * a.o_st + d], sDO[i * DPV + d], acc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) {
        sDl[i] = acc;
        if (t < a.Tq) a.delta[((long long)b * a.Tq + t) * a.Hq + h] = acc;
      }
    }
  }

  float acc[4][NCK];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int dd = 0; dd < NCK; ++dd) acc[ii][dd] = 0.f;

  for (int j = lo; j <= hi; ++j) {
    const int k0 = j * BC;
    __syncthreads();  // the previous tile's sK / sV / sS are consumed
    load_tile<DK>(sK, kb, a.k_st, k0, a.Tk);
    load_tile<DV>(sV, vb, a.v_st, k0, a.Tk);
    if (a.has_seg && tid < BC) {
      const int t = k0 + tid;
      sKs[tid] = t < a.Tk ? a.kseg[b * a.ks_sb + t] : -2;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[ii][jj] = dp[ii][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DM; ++d) {
      float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        qv[ii] = sQ[(rg * 4 + ii) * DPK + d];
        gv[ii] = sDO[(rg * 4 + ii) * DPV + d];
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        kv[jj] = sK[(cl + 16 * jj) * DPK + d];
        vv[jj] = sV[(cl + 16 * jj) * DPV + d];
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          s[ii][jj] = fmaf(qv[ii], kv[jj], s[ii][jj]);
          dp[ii][jj] = fmaf(gv[ii], vv[jj], dp[ii][jj]);
        }
    }
    // the rest of the wider head dim (none when DK == DV)
#pragma unroll 4
    for (int d = DM; d < DK; ++d)
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          s[ii][jj] = fmaf(sQ[(rg * 4 + ii) * DPK + d],
                           sK[(cl + 16 * jj) * DPK + d], s[ii][jj]);
#pragma unroll 4
    for (int d = DM; d < DV; ++d)
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          dp[ii][jj] = fmaf(sDO[(rg * 4 + ii) * DPV + d],
                            sV[(cl + 16 * jj) * DPV + d], dp[ii][jj]);

    const bool edge = a.masked && (j < ilo || j > ihi);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int row = rg * 4 + ii;
      const float L = sL[row];
      const bool live = L > kNegInf * 0.5f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = cl + 16 * jj;
        const int kl = k0 + col;
        bool ok = live && kl < a.Tk;
        if (ok && edge)
          ok = allowed(a, a.q_offset + q0 + row, a.kv_offset + kl, sQs[row],
                       sKs[col]);
        const float p = ok ? expf(s[ii][jj] * a.scale - L) : 0.f;
        sS[row * PP + col] = p * (dp[ii][jj] - sDl[row]) * a.scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int jj = 0; jj < BC; ++jj) {
      float kv[NCK];
#pragma unroll
      for (int dd = 0; dd < NCK; ++dd) kv[dd] = sK[jj * DPK + cl + 16 * dd];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float ds = sS[(rg * 4 + ii) * PP + jj];
#pragma unroll
        for (int dd = 0; dd < NCK; ++dd)
          acc[ii][dd] = fmaf(ds, kv[dd], acc[ii][dd]);
      }
    }
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int t = q0 + rg * 4 + ii;
    if (t >= a.Tq) continue;
    float* out =
        static_cast<float*>(a.dq) + b * a.dq_sb + t * a.dq_st + h * a.dq_sh;
#pragma unroll
    for (int dd = 0; dd < NCK; ++dd) out[cl + 16 * dd] = acc[ii][dd];
  }
}

// ---------------------------------------------------------------- kernel D

template <int DK, int DV>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(BwdParams a) {
  constexpr int DPK = DK + 1;
  constexpr int DPV = DV + 1;
  constexpr int DM = DK < DV ? DK : DV;
  constexpr int PP = BR + 1;
  constexpr int NCK = DK / 16;  // dk columns a thread
  constexpr int NCV = DV / 16;  // dv columns a thread
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BC * DPK;
  float* sQ = sV + BC * DPV;
  float* sDO = sQ + BR * DPK;
  float* sP = sDO + BR * DPV;  // p tile, key rows × q columns
  float* sDS = sP + BC * PP;   // ds tile, key rows × q columns
  float* sL = sDS + BC * PP;
  float* sDl = sL + BR;
  int* sQs = reinterpret_cast<int*>(sDl + BR);
  int* sKs = sQs + BR;

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int rg = tid >> 4;
  const int cl = tid & 15;
  const int k0 = kt * BC;
  const int qlo = a.qbounds[2 * kt], qhi = a.qbounds[2 * kt + 1];

  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  load_tile<DK>(sK, kb, a.k_st, k0, a.Tk);
  load_tile<DV>(sV, vb, a.v_st, k0, a.Tk);
  if (a.has_seg && tid < BC) {
    const int t = k0 + tid;
    sKs[tid] = t < a.Tk ? a.kseg[b * a.ks_sb + t] : -2;
  }

  float dk[4][NCK], dv[4][NCV];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
    for (int dd = 0; dd < NCK; ++dd) dk[ii][dd] = 0.f;
#pragma unroll
    for (int dd = 0; dd < NCV; ++dd) dv[ii][dd] = 0.f;
  }

  for (int hh = 0; hh < a.group; ++hh) {
    const int h = hk * a.group + hh;
    const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
    const float* dob =
        static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh;
    for (int i = qlo; i <= qhi; ++i) {
      const int q0 = i * BR;
      __syncthreads();  // the previous q tile's sQ / sDO / sP / sDS consumed
      load_tile<DK>(sQ, qb, a.q_st, q0, a.Tq);
      load_tile<DV>(sDO, dob, a.do_st, q0, a.Tq);
      if (tid < BR) {
        const int t = q0 + tid;
        const long long si = ((long long)b * a.Tq + t) * a.Hq + h;
        sL[tid] = t < a.Tq ? a.lse[si] : kNegInf;
        sDl[tid] = t < a.Tq ? a.delta[si] : 0.f;
        if (a.has_seg) sQs[tid] = t < a.Tq ? a.qseg[b * a.qs_sb + t] : -1;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[ii][jj] = dp[ii][jj] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DM; ++d) {
        float kv[4], vv[4], qv[4], gv[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          kv[ii] = sK[(rg * 4 + ii) * DPK + d];
          vv[ii] = sV[(rg * 4 + ii) * DPV + d];
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          qv[jj] = sQ[(cl + 16 * jj) * DPK + d];
          gv[jj] = sDO[(cl + 16 * jj) * DPV + d];
        }
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            s[ii][jj] = fmaf(kv[ii], qv[jj], s[ii][jj]);
            dp[ii][jj] = fmaf(vv[ii], gv[jj], dp[ii][jj]);
          }
      }
      // the rest of the wider head dim (none when DK == DV)
#pragma unroll 4
      for (int d = DM; d < DK; ++d)
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            s[ii][jj] = fmaf(sK[(rg * 4 + ii) * DPK + d],
                             sQ[(cl + 16 * jj) * DPK + d], s[ii][jj]);
#pragma unroll 4
      for (int d = DM; d < DV; ++d)
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            dp[ii][jj] = fmaf(sV[(rg * 4 + ii) * DPV + d],
                              sDO[(cl + 16 * jj) * DPV + d], dp[ii][jj]);

      // interior tiles (every pair attends) come from the forward's table
      const bool edge =
          a.masked && (kt < a.bounds[4 * i + 2] || kt > a.bounds[4 * i + 3]);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int kr = rg * 4 + ii;
        const int kl = k0 + kr;
        const bool kin = kl < a.Tk;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int qc = cl + 16 * jj;
          const float L = sL[qc];
          bool ok = kin && L > kNegInf * 0.5f;
          if (ok && edge)
            ok = allowed(a, a.q_offset + q0 + qc, a.kv_offset + kl, sQs[qc],
                         sKs[kr]);
          const float p = ok ? expf(s[ii][jj] * a.scale - L) : 0.f;
          sP[kr * PP + qc] = p;
          sDS[kr * PP + qc] = p * (dp[ii][jj] - sDl[qc]) * a.scale;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int qc = 0; qc < BR; ++qc) {
        float qv[NCK], gv[NCV];
#pragma unroll
        for (int dd = 0; dd < NCK; ++dd) qv[dd] = sQ[qc * DPK + cl + 16 * dd];
#pragma unroll
        for (int dd = 0; dd < NCV; ++dd) gv[dd] = sDO[qc * DPV + cl + 16 * dd];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const float p = sP[(rg * 4 + ii) * PP + qc];
          const float ds = sDS[(rg * 4 + ii) * PP + qc];
#pragma unroll
          for (int dd = 0; dd < NCV; ++dd)
            dv[ii][dd] = fmaf(p, gv[dd], dv[ii][dd]);
#pragma unroll
          for (int dd = 0; dd < NCK; ++dd)
            dk[ii][dd] = fmaf(ds, qv[dd], dk[ii][dd]);
        }
      }
    }
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int t = k0 + rg * 4 + ii;
    if (t >= a.Tk) continue;
    float* ko =
        static_cast<float*>(a.dk) + b * a.dk_sb + t * a.dk_st + hk * a.dk_sh;
    float* vo =
        static_cast<float*>(a.dv) + b * a.dv_sb + t * a.dv_st + hk * a.dv_sh;
#pragma unroll
    for (int dd = 0; dd < NCK; ++dd) ko[cl + 16 * dd] = dk[ii][dd];
#pragma unroll
    for (int dd = 0; dd < NCV; ++dd) vo[cl + 16 * dd] = dv[ii][dd];
  }
}

// ---------------------------------------------------------------- launch

template <int DK, int DV>
cudaError_t launch_dq(const BwdParams& p, int nq, int B, cudaStream_t s) {
  const size_t smem = dq_smem_bytes<DK, DV>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<DK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  flash_bwd_dq_kernel<DK, DV><<<dim3(nq, p.Hq, B), NT, smem, s>>>(p);
  return cudaGetLastError();
}

template <int DK, int DV>
cudaError_t launch_dkv(const BwdParams& p, int nk, int Hkv, int B,
                       cudaStream_t s) {
  const size_t smem = dkv_smem_bytes<DK, DV>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<DK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  flash_bwd_dkv_kernel<DK, DV><<<dim3(nk, Hkv, B), NT, smem, s>>>(p);
  return cudaGetLastError();
}

cudaError_t dq_d(const BwdParams& p, const Shape& sh, cudaStream_t s) {
  if (sh.D == 192 && sh.Dv == 128)
    return launch_dq<192, 128>(p, sh.nq, sh.B, s);
  if (sh.Dv != sh.D) return cudaErrorInvalidValue;
  switch (sh.D) {
    case 32: return launch_dq<32, 32>(p, sh.nq, sh.B, s);
    case 64: return launch_dq<64, 64>(p, sh.nq, sh.B, s);
    case 128: return launch_dq<128, 128>(p, sh.nq, sh.B, s);
    case 160: return launch_dq<160, 160>(p, sh.nq, sh.B, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dkv_d(const BwdParams& p, const Shape& sh, cudaStream_t s) {
  if (sh.D == 192 && sh.Dv == 128)
    return launch_dkv<192, 128>(p, sh.nk, sh.Hkv, sh.B, s);
  if (sh.Dv != sh.D) return cudaErrorInvalidValue;
  switch (sh.D) {
    case 32: return launch_dkv<32, 32>(p, sh.nk, sh.Hkv, sh.B, s);
    case 64: return launch_dkv<64, 64>(p, sh.nk, sh.Hkv, sh.B, s);
    case 128: return launch_dkv<128, 128>(p, sh.nk, sh.Hkv, sh.B, s);
    case 160: return launch_dkv<160, 160>(p, sh.nk, sh.Hkv, sh.B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Kernel C, float32.  Writes dq and, when compute_delta, delta.  Returns
// the CUDA error code of the launch (0 = launched).
extern "C" int repro_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout,
                                  const void* lse, void* delta, void* dq,
                                  const void* bounds, const void* qseg,
                                  const void* kseg, const long long* ia,
                                  float scale, void* stream) {
  Shape sh;
  const BwdParams p = repro_bwd::dq_args(q, k, v, o, dout, lse, delta, dq,
                                         bounds, qseg, kseg, ia, scale, &sh);
  if (sh.dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dq_d(p, sh, static_cast<cudaStream_t>(stream)));
}

// Kernel D, float32.  Reads delta (written by kernel C or passed in);
// writes dk and dv.  Returns the CUDA error code of the launch (0 =
// launched).
extern "C" int repro_flash_bwd_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, const void* bounds,
                                   const void* qbounds, const void* qseg,
                                   const void* kseg, const long long* ia,
                                   float scale, void* stream) {
  Shape sh;
  const BwdParams p = repro_bwd::dkv_args(q, k, v, dout, lse, delta, dk, dv,
                                          bounds, qbounds, qseg, kseg, ia,
                                          scale, &sh);
  if (sh.dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dkv_d(p, sh, static_cast<cudaStream_t>(stream)));
}

// Dynamic shared memory of kernel C (kernel 0) or D (kernel 1) at head dims
// (dk, dv), in bytes; 0 for a pair the kernels do not take.
extern "C" int repro_flash_bwd_smem(int kernel, int dk, int dv) {
  if (dk == 192 && dv == 128)
    return static_cast<int>(kernel ? dkv_smem_bytes<192, 128>()
                                   : dq_smem_bytes<192, 128>());
  if (dk != dv) return 0;
  switch (dk) {
    case 32: return static_cast<int>(kernel ? dkv_smem_bytes<32, 32>()
                                            : dq_smem_bytes<32, 32>());
    case 64: return static_cast<int>(kernel ? dkv_smem_bytes<64, 64>()
                                            : dq_smem_bytes<64, 64>());
    case 128: return static_cast<int>(kernel ? dkv_smem_bytes<128, 128>()
                                             : dq_smem_bytes<128, 128>());
    case 160: return static_cast<int>(kernel ? dkv_smem_bytes<160, 160>()
                                             : dq_smem_bytes<160, 160>());
    default: return 0;
  }
}

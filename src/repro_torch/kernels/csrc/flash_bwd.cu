// Kernels C and D: the FlashAttention-2 backward of one partial attention
// chunk, written by hand for Hopper (sm_90a), with plain C entry points bound
// via ctypes.  Together with kernel A (flash_fwd.cu) they are the complete
// gradient of a chunk: from the saved (o, lse) they give dq, dk and dv, and
// they never rerun the forward.
//
// Replaces the TPU kernels of the JAX package's `flash_bwd_bhtd`
// (src/repro/kernels/flash_attention.py):
//   C `_dq_kernel`  (:280, pallas_call at :417) -> flash_bwd_dq_kernel
//   D `_dkv_kernel` (:322, pallas_call at :450) -> flash_bwd_dkv_kernel
//
// Bound on the H100: operations, at the training shape.  One llama-7b
// attention backward (B 1, T 8192, 32 heads of 128, bf16, causal) has
// 1.07e9 unmasked (row, key) pairs.  C does 6·D FLOPs per pair (s = q·kᵀ,
// dp = do·vᵀ, dq += ds·k) and D does 8·D (s, dp, dv += pᵀ·do, dk += dsᵀ·q):
// 0.82 and 1.10 TFLOP over about 0.40 GB each, some 2,000 FLOP per byte,
// far above the card's ridge of 295 FLOP/byte.  So the least times are the
// bf16 tensor-core rate's 0.83 and 1.11 ms.  This first version does every
// product with IEEE float32 FMAs on the CUDA cores (float32 parity needs
// them, and no TF32), so its ceiling is the card's 67 TFLOP/s of float32 and
// its time is set by FMA throughput and shared-memory traffic; tensor-core
// `mma`/`wgmma` for bf16 is later work.  What the design does about the
// bound: no score, probability or ds tile reaches device memory; the host
// tables skip every tile the mask cannot reach (half of them, causally);
// the element-wise mask runs only on edge tiles; and D sums dk and dv over
// the GQA group on chip, so nothing is reduced in device memory afterwards.
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
// Shared memory at D = 128 is 150 KB (C) and 166 KB (D), above the 48 KB
// default, so each launch raises the kernel's dynamic shared-memory limit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int BR = 64;   // q rows per tile
constexpr int BC = 64;   // keys per tile
constexpr int NT = 256;  // threads per block

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;   // (B, Tq, Hq)
  float* delta;       // (B, Tq, Hq): written by C when compute_delta
  void* dq;
  void* dk;
  void* dv;
  const int* bounds;   // (nq, 4): kv-tile lo, hi, interior lo, interior hi
  const int* qbounds;  // (nk, 2): q-tile lo, hi
  const int* qseg;     // (B, Tq) segment ids, batch stride qs_sb (may be 0)
  const int* kseg;     // (B, Tk)
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;
  long long do_sb, do_st, do_sh;
  long long dq_sb, dq_st, dq_sh;
  long long dk_sb, dk_st, dk_sh;
  long long dv_sb, dv_st, dv_sh;
  long long qs_sb, ks_sb;
  int Tq, Tk, Hq, group;
  int causal, window, prefix_len, q_offset, kv_offset, has_seg, masked;
  int compute_delta;
  float scale;
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// The MaskSpec of one (query, key) position pair (core/mask.py).
__device__ __forceinline__ bool allowed(const BwdParams& a, int qp, int kp,
                                        const int* qs, const int* ks) {
  const bool pre = a.prefix_len > 0 && kp < a.prefix_len;
  bool ok = true;
  if (a.causal) ok = kp <= qp || pre;
  if (ok && a.window > 0) ok = qp - kp < a.window || pre;
  if (ok && a.has_seg) ok = *qs == *ks || pre;
  return ok;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) *
             (2 * BR * (D + 1) + 2 * BC * (D + 1) + BR * (BC + 1) + 2 * BR) +
         sizeof(int) * (BR + BC);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) *
             (2 * BC * (D + 1) + 2 * BR * (D + 1) + 2 * BC * (BR + 1) +
              2 * BR) +
         sizeof(int) * (BR + BC);
}

// Loads rows [t0, t0 + 64) of one head of a (B, T, H, D) tensor into a
// padded float tile; rows at or past T read as 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          long long st, int t0, int T_len) {
  constexpr int DP = D + 1;
  for (int idx = threadIdx.x; idx < 64 * D; idx += NT) {
    const int i = idx / D, d = idx - i * D;
    const int t = t0 + i;
    dst[i * DP + d] = t < T_len ? load_f(base + t * st + d) : 0.f;
  }
}

// ---------------------------------------------------------------- kernel C

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(BwdParams a) {
  constexpr int DP = D + 1;
  constexpr int PP = BC + 1;
  constexpr int DV = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + BR * DP;
  float* sK = sDO + BR * DP;
  float* sV = sK + BC * DP;
  float* sS = sV + BC * DP;  // ds tile
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

  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* dob = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  load_tile<T, D>(sQ, qb, a.q_st, q0, a.Tq);
  load_tile<T, D>(sDO, dob, a.do_st, q0, a.Tq);
  if (tid < BR) {
    const int t = q0 + tid;
    const long long si = ((long long)b * a.Tq + t) * a.Hq + h;
    sL[tid] = t < a.Tq ? a.lse[si] : kNegInf;
    if (!a.compute_delta) sDl[tid] = t < a.Tq ? a.delta[si] : 0.f;
    if (a.has_seg) sQs[tid] = t < a.Tq ? a.qseg[b * a.qs_sb + t] : -1;
  }
  if (a.compute_delta) {  // delta = rowsum(o ⊙ do): one warp per row
    __syncthreads();
    const T* ob = static_cast<const T*>(a.o) + b * a.o_sb + h * a.o_sh;
    const int warp = tid >> 5, lane = tid & 31;
    for (int i = warp; i < BR; i += NT / 32) {
      const int t = q0 + i;
      float acc = 0.f;
      if (t < a.Tq)
        for (int d = lane; d < D; d += 32)
          acc = fmaf(load_f(ob + t * a.o_st + d), sDO[i * DP + d], acc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) {
        sDl[i] = acc;
        if (t < a.Tq) a.delta[((long long)b * a.Tq + t) * a.Hq + h] = acc;
      }
    }
  }

  float acc[4][DV];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int dd = 0; dd < DV; ++dd) acc[ii][dd] = 0.f;

  for (int j = lo; j <= hi; ++j) {
    const int k0 = j * BC;
    __syncthreads();  // the previous tile's sK / sV / sS are consumed
    load_tile<T, D>(sK, kb, a.k_st, k0, a.Tk);
    load_tile<T, D>(sV, vb, a.v_st, k0, a.Tk);
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
    for (int d = 0; d < D; ++d) {
      float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        qv[ii] = sQ[(rg * 4 + ii) * DP + d];
        gv[ii] = sDO[(rg * 4 + ii) * DP + d];
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        kv[jj] = sK[(cl + 16 * jj) * DP + d];
        vv[jj] = sV[(cl + 16 * jj) * DP + d];
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          s[ii][jj] = fmaf(qv[ii], kv[jj], s[ii][jj]);
          dp[ii][jj] = fmaf(gv[ii], vv[jj], dp[ii][jj]);
        }
    }

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
          ok = allowed(a, a.q_offset + q0 + row, a.kv_offset + kl, sQs + row,
                       sKs + col);
        const float p = ok ? expf(s[ii][jj] * a.scale - L) : 0.f;
        sS[row * PP + col] = p * (dp[ii][jj] - sDl[row]) * a.scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int jj = 0; jj < BC; ++jj) {
      float kv[DV];
#pragma unroll
      for (int dd = 0; dd < DV; ++dd) kv[dd] = sK[jj * DP + cl + 16 * dd];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float ds = sS[(rg * 4 + ii) * PP + jj];
#pragma unroll
        for (int dd = 0; dd < DV; ++dd)
          acc[ii][dd] = fmaf(ds, kv[dd], acc[ii][dd]);
      }
    }
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int t = q0 + rg * 4 + ii;
    if (t >= a.Tq) continue;
    T* out = static_cast<T*>(a.dq) + b * a.dq_sb + t * a.dq_st + h * a.dq_sh;
#pragma unroll
    for (int dd = 0; dd < DV; ++dd) store_f(out + cl + 16 * dd, acc[ii][dd]);
  }
}

// ---------------------------------------------------------------- kernel D

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(BwdParams a) {
  constexpr int DP = D + 1;
  constexpr int PP = BR + 1;
  constexpr int DV = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BC * DP;
  float* sQ = sV + BC * DP;
  float* sDO = sQ + BR * DP;
  float* sP = sDO + BR * DP;   // p tile, key rows × q columns
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

  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  load_tile<T, D>(sK, kb, a.k_st, k0, a.Tk);
  load_tile<T, D>(sV, vb, a.v_st, k0, a.Tk);
  if (a.has_seg && tid < BC) {
    const int t = k0 + tid;
    sKs[tid] = t < a.Tk ? a.kseg[b * a.ks_sb + t] : -2;
  }

  float dk[4][DV], dv[4][DV];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int dd = 0; dd < DV; ++dd) dk[ii][dd] = dv[ii][dd] = 0.f;

  for (int hh = 0; hh < a.group; ++hh) {
    const int h = hk * a.group + hh;
    const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* dob = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
    for (int i = qlo; i <= qhi; ++i) {
      const int q0 = i * BR;
      __syncthreads();  // the previous q tile's sQ / sDO / sP / sDS consumed
      load_tile<T, D>(sQ, qb, a.q_st, q0, a.Tq);
      load_tile<T, D>(sDO, dob, a.do_st, q0, a.Tq);
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
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[4], gv[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          kv[ii] = sK[(rg * 4 + ii) * DP + d];
          vv[ii] = sV[(rg * 4 + ii) * DP + d];
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          qv[jj] = sQ[(cl + 16 * jj) * DP + d];
          gv[jj] = sDO[(cl + 16 * jj) * DP + d];
        }
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            s[ii][jj] = fmaf(kv[ii], qv[jj], s[ii][jj]);
            dp[ii][jj] = fmaf(vv[ii], gv[jj], dp[ii][jj]);
          }
      }

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
            ok = allowed(a, a.q_offset + q0 + qc, a.kv_offset + kl, sQs + qc,
                         sKs + kr);
          const float p = ok ? expf(s[ii][jj] * a.scale - L) : 0.f;
          sP[kr * PP + qc] = p;
          sDS[kr * PP + qc] = p * (dp[ii][jj] - sDl[qc]) * a.scale;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int qc = 0; qc < BR; ++qc) {
        float qv[DV], gv[DV];
#pragma unroll
        for (int dd = 0; dd < DV; ++dd) {
          qv[dd] = sQ[qc * DP + cl + 16 * dd];
          gv[dd] = sDO[qc * DP + cl + 16 * dd];
        }
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const float p = sP[(rg * 4 + ii) * PP + qc];
          const float ds = sDS[(rg * 4 + ii) * PP + qc];
#pragma unroll
          for (int dd = 0; dd < DV; ++dd) {
            dv[ii][dd] = fmaf(p, gv[dd], dv[ii][dd]);
            dk[ii][dd] = fmaf(ds, qv[dd], dk[ii][dd]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int t = k0 + rg * 4 + ii;
    if (t >= a.Tk) continue;
    T* ko = static_cast<T*>(a.dk) + b * a.dk_sb + t * a.dk_st + hk * a.dk_sh;
    T* vo = static_cast<T*>(a.dv) + b * a.dv_sb + t * a.dv_st + hk * a.dv_sh;
#pragma unroll
    for (int dd = 0; dd < DV; ++dd) {
      store_f(ko + cl + 16 * dd, dk[ii][dd]);
      store_f(vo + cl + 16 * dd, dv[ii][dd]);
    }
  }
}

// ---------------------------------------------------------------- launch

template <typename T, int D>
cudaError_t launch_dq(const BwdParams& p, int nq, int B, cudaStream_t s) {
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  flash_bwd_dq_kernel<T, D><<<dim3(nq, p.Hq, B), NT, smem, s>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const BwdParams& p, int nk, int Hkv, int B,
                       cudaStream_t s) {
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  flash_bwd_dkv_kernel<T, D><<<dim3(nk, Hkv, B), NT, smem, s>>>(p);
  return cudaGetLastError();
}

struct Shape {
  int B, Hkv, D, dtype, nq, nk;
};

// ia (int64): B, Tq, Tk, Hq, Hkv, D, dtype (0 f32, 1 bf16), nq, nk,
//   strides (b, t, h) of q, k, v, o, do, dq, dk, dv,
//   causal, window, prefix_len, q_offset, kv_offset, has_seg,
//   q-segment batch stride, kv-segment batch stride, masked, compute_delta.
Shape parse(const long long* ia, BwdParams* p) {
  Shape sh;
  sh.B = static_cast<int>(ia[0]);
  p->Tq = static_cast<int>(ia[1]);
  p->Tk = static_cast<int>(ia[2]);
  p->Hq = static_cast<int>(ia[3]);
  sh.Hkv = static_cast<int>(ia[4]);
  p->group = p->Hq / sh.Hkv;
  sh.D = static_cast<int>(ia[5]);
  sh.dtype = static_cast<int>(ia[6]);
  sh.nq = static_cast<int>(ia[7]);
  sh.nk = static_cast<int>(ia[8]);
  long long* st[8][3] = {
      {&p->q_sb, &p->q_st, &p->q_sh},    {&p->k_sb, &p->k_st, &p->k_sh},
      {&p->v_sb, &p->v_st, &p->v_sh},    {&p->o_sb, &p->o_st, &p->o_sh},
      {&p->do_sb, &p->do_st, &p->do_sh}, {&p->dq_sb, &p->dq_st, &p->dq_sh},
      {&p->dk_sb, &p->dk_st, &p->dk_sh}, {&p->dv_sb, &p->dv_st, &p->dv_sh}};
  for (int t = 0; t < 8; ++t)
    for (int c = 0; c < 3; ++c) *st[t][c] = ia[9 + 3 * t + c];
  p->causal = static_cast<int>(ia[33]);
  p->window = static_cast<int>(ia[34]);
  p->prefix_len = static_cast<int>(ia[35]);
  p->q_offset = static_cast<int>(ia[36]);
  p->kv_offset = static_cast<int>(ia[37]);
  p->has_seg = static_cast<int>(ia[38]);
  p->qs_sb = ia[39];
  p->ks_sb = ia[40];
  p->masked = static_cast<int>(ia[41]);
  p->compute_delta = static_cast<int>(ia[42]);
  return sh;
}

template <typename T>
cudaError_t dq_d(const BwdParams& p, const Shape& sh, cudaStream_t s) {
  switch (sh.D) {
    case 32: return launch_dq<T, 32>(p, sh.nq, sh.B, s);
    case 64: return launch_dq<T, 64>(p, sh.nq, sh.B, s);
    case 128: return launch_dq<T, 128>(p, sh.nq, sh.B, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dkv_d(const BwdParams& p, const Shape& sh, cudaStream_t s) {
  switch (sh.D) {
    case 32: return launch_dkv<T, 32>(p, sh.nk, sh.Hkv, sh.B, s);
    case 64: return launch_dkv<T, 64>(p, sh.nk, sh.Hkv, sh.B, s);
    case 128: return launch_dkv<T, 128>(p, sh.nk, sh.Hkv, sh.B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Kernel C.  Writes dq and, when compute_delta, delta.  Returns the CUDA
// error code of the launch (0 = launched).
extern "C" int repro_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout,
                                  const void* lse, void* delta, void* dq,
                                  const void* bounds, const void* qseg,
                                  const void* kseg, const long long* ia,
                                  float scale, void* stream) {
  BwdParams p = {};
  const Shape sh = parse(ia, &p);
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = dq;
  p.bounds = static_cast<const int*>(bounds);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sh.dtype == 0) return static_cast<int>(dq_d<float>(p, sh, s));
  if (sh.dtype == 1) return static_cast<int>(dq_d<__nv_bfloat16>(p, sh, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Kernel D.  Reads delta (written by kernel C or passed in); writes dk and
// dv.  Returns the CUDA error code of the launch (0 = launched).
extern "C" int repro_flash_bwd_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, const void* bounds,
                                   const void* qbounds, const void* qseg,
                                   const void* kseg, const long long* ia,
                                   float scale, void* stream) {
  BwdParams p = {};
  const Shape sh = parse(ia, &p);
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = const_cast<float*>(static_cast<const float*>(delta));
  p.dk = dk;
  p.dv = dv;
  p.bounds = static_cast<const int*>(bounds);
  p.qbounds = static_cast<const int*>(qbounds);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sh.dtype == 0) return static_cast<int>(dkv_d<float>(p, sh, s));
  if (sh.dtype == 1) return static_cast<int>(dkv_d<__nv_bfloat16>(p, sh, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Kernel A, float32 route: FlashAttention-2 forward of one partial attention
// chunk on the CUDA cores, written by hand for Hopper (sm_90a), with a plain
// C entry point bound via ctypes.  bf16 inputs (the serving and training
// paths' dtype) take the tensor-core route, flash_fwd_sm90.cu.
//
// Replaces the TPU kernel `_fwd_kernel` / `flash_fwd_bhtd` of the JAX package
// (src/repro/kernels/flash_attention.py:157, pallas_call at :252).
//
// Bound on the H100: bytes, at the serving shape.  One llama-7b prefill chunk
// (B 1, Tq 256 at q_offset 768, Tk 1024 after the engine's table bucketing,
// 32 heads of 128, bf16) does 4·D FLOPs for each of the 229,504 (row, key)
// pairs the causal mask allows per head (12% fewer than the full 256 × 1024):
// 3.76 GFLOP over 21.0 MB of q, k, v, o and lse, or 179 FLOP/byte.  That is
// below the card's ridge point of 989 TFLOP/s / 3.35 TB/s = 295 FLOP/byte,
// so the least time is the bytes' 6.3 us.  (Each key brings 4·D bytes of k
// and v and at most 4·D·Tq FLOPs, so with Tq = 256 the intensity stays below
// 256 FLOP/byte at any context length.)  This
// route does its two products with IEEE float32 FMAs out of shared memory,
// for the float32 bar (1e-5), so the FLOPs, not the bytes, set its time.
// What the design does about the bound: every input is read once per q
// tile, no score tile reaches device memory, and the block-sparse table
// skips every KV tile the mask cannot reach.
//
// Design.  One thread block (256 threads) per (64-row q tile, query head,
// batch row).  The block loops over the 64-key tiles [lo, hi] that the
// wrapper computed on the host from the static MaskSpec
// (kernels/block_sparse.kv_block_bounds) and keeps the online-softmax state
// (m, l, o accumulator) in registers: thread (rg, cl) owns rows 4·rg..4·rg+3
// and key columns cl + 16·j of the score tile, and output columns cl + 16·j.
// The MaskSpec is evaluated element-wise only on edge tiles, those outside
// the interior range [ilo, ihi] (kernels/block_sparse.interior_kv_bounds).
// Head dims 32, 64, 128 and 160 (zamba2's shared attention block; 141 KB of
// shared memory).
// Tensors are read in the model's (B, T, H, D) layout through strides; ragged
// Tq and Tk are masked at the edge.  GQA maps query head h to kv head
// h / group.  NEG_INF handling reproduces the reference's m_safe / alpha rules
// (flash_attention.py:187-206): an empty row gives o = 0 and lse = NEG_INF.
#include <cuda_runtime.h>

#include "flash_fwd_common.cuh"

namespace {

using repro_fwd::FwdParams;
using repro_fwd::Shape;
using repro_fwd::allowed;
using repro_fwd::kNegInf;

constexpr int BR = 64;   // q rows per tile
constexpr int BC = 64;   // keys per tile
constexpr int NT = 256;  // threads per block

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) *
             (BR * (D + 1) + BC * (D + 1) + BC * D + BR * (BC + 1)) +
         sizeof(int) * (BR + BC);
}

template <int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(FwdParams a) {
  constexpr int DP = D + 1;   // padded row stride: conflict-free column reads
  constexpr int PP = BC + 1;
  constexpr int DV = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BR * DP;
  float* sV = sK + BC * DP;
  float* sP = sV + BC * D;
  int* sQs = reinterpret_cast<int*>(sP + BR * PP);
  int* sKs = sQs + BR;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.group;
  const int tid = threadIdx.x;
  const int rg = tid >> 4;  // row group: rows 4·rg .. 4·rg+3
  const int cl = tid & 15;  // column lane
  const int q0 = qt * BR;
  const int lo = a.bounds[4 * qt], hi = a.bounds[4 * qt + 1];
  const int ilo = a.bounds[4 * qt + 2], ihi = a.bounds[4 * qt + 3];

  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;

  for (int idx = tid; idx < BR * D; idx += NT) {
    const int i = idx / D, d = idx - i * D;
    const int t = q0 + i;
    sQ[i * DP + d] = t < a.Tq ? qb[t * a.q_st + d] : 0.f;
  }
  if (a.has_seg && tid < BR) {
    const int t = q0 + tid;
    sQs[tid] = t < a.Tq ? a.qseg[b * a.qs_sb + t] : -1;
  }

  float m[4], l[4], acc[4][DV];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    m[ii] = kNegInf;
    l[ii] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DV; ++dd) acc[ii][dd] = 0.f;
  }

  for (int j = lo; j <= hi; ++j) {
    const int k0 = j * BC;
    __syncthreads();  // the previous tile's sK / sV / sP are consumed
    for (int idx = tid; idx < BC * D; idx += NT) {
      const int jj = idx / D, d = idx - jj * D;
      const int t = k0 + jj;
      const bool ok = t < a.Tk;
      sK[jj * DP + d] = ok ? kb[t * a.k_st + d] : 0.f;
      sV[jj * D + d] = ok ? vb[t * a.v_st + d] : 0.f;
    }
    if (a.has_seg && tid < BC) {
      const int t = k0 + tid;
      sKs[tid] = t < a.Tk ? a.kseg[b * a.ks_sb + t] : -2;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[ii][jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) qv[ii] = sQ[(rg * 4 + ii) * DP + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = sK[(cl + 16 * jj) * DP + d];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          s[ii][jj] = fmaf(qv[ii], kv[jj], s[ii][jj]);
    }

    const bool edge = a.masked && (j < ilo || j > ihi);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int row = rg * 4 + ii;
      const int qp = a.q_offset + q0 + row;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = cl + 16 * jj;
        const int kl = k0 + col;
        bool ok = kl < a.Tk;
        if (ok && edge)
          ok = allowed(a, qp, a.kv_offset + kl, a.has_seg ? sQs[row] : 0,
                       a.has_seg ? sKs[col] : 0);
        s[ii][jj] = ok ? s[ii][jj] * a.scale : kNegInf;
      }
    }

    // online softmax: the 16 lanes of a row group hold one row's 64 columns
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      float mx = fmaxf(fmaxf(s[ii][0], s[ii][1]), fmaxf(s[ii][2], s[ii][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[ii], mx);
      const float m_safe = fmaxf(m_new, kNegInf * 0.5f);
      const bool dead = m_new <= kNegInf * 0.5f;
      float ps = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = dead ? 0.f : expf(s[ii][jj] - m_safe);
        sP[(rg * 4 + ii) * PP + cl + 16 * jj] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      const float alpha =
          m[ii] <= kNegInf * 0.5f ? 0.f : expf(m[ii] - m_safe);
      l[ii] = alpha * l[ii] + ps;
      m[ii] = m_new;
#pragma unroll
      for (int dd = 0; dd < DV; ++dd) acc[ii][dd] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int jj = 0; jj < BC; ++jj) {
      float vv[DV];
#pragma unroll
      for (int dd = 0; dd < DV; ++dd) vv[dd] = sV[jj * D + cl + 16 * dd];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float p = sP[(rg * 4 + ii) * PP + jj];
#pragma unroll
        for (int dd = 0; dd < DV; ++dd) acc[ii][dd] = fmaf(p, vv[dd], acc[ii][dd]);
      }
    }
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int t = q0 + rg * 4 + ii;
    if (t >= a.Tq) continue;
    const float ls = l[ii] == 0.f ? 1.f : l[ii];
    float* ob = static_cast<float*>(a.o) + b * a.o_sb + t * a.o_st + h * a.o_sh;
#pragma unroll
    for (int dd = 0; dd < DV; ++dd) ob[cl + 16 * dd] = acc[ii][dd] / ls;
    if (cl == 0)
      a.lse[((long long)b * a.Tq + t) * a.Hq + h] =
          l[ii] == 0.f ? kNegInf : m[ii] + logf(ls);
  }
}

template <int D>
cudaError_t launch(const FwdParams& p, int nq, int B, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  flash_fwd_kernel<D><<<dim3(nq, p.Hq, B), NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Float32 only (ia's dtype must be 0); ia as in flash_fwd_common.cuh.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, void* lse, const void* bounds,
                               const void* qseg, const void* kseg,
                               const long long* ia, float scale,
                               void* stream) {
  Shape sh;
  const FwdParams p = repro_fwd::parse(q, k, v, o, lse, bounds, qseg, kseg,
                                       ia, scale, &sh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sh.dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (sh.D) {
    case 32: return static_cast<int>(launch<32>(p, sh.nq, sh.B, s));
    case 64: return static_cast<int>(launch<64>(p, sh.nq, sh.B, s));
    case 128: return static_cast<int>(launch<128>(p, sh.nq, sh.B, s));
    case 160: return static_cast<int>(launch<160>(p, sh.nq, sh.B, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

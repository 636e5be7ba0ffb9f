// Kernel A, latent and pair routes, float32: FlashAttention-2 forward of
// one partial attention chunk whose q/k head dim DK differs from v's DV, on
// the CUDA cores, written by hand for Hopper (sm_90a), with a plain C entry
// point bound via ctypes.  Two instantiations.  <576, 512> serves absorbed
// multi-head latent attention (DeepSeek MLA's chunks and the paged path):
// DK = 576 (the kv_lora 512 latent ⊕ rope 64), DV = 512, one kv head under
// a GQA group of every query head, v the first 512 columns of k (a strided
// view).  <192, 128> serves materialised MLA (the whole-prompt prefill):
// per head q/k of nope 128 ⊕ rope 64 and a v of its own, 16 kv heads under
// a group of 1.  IEEE float32 products, for the float32 bar (1e-5); bf16
// inputs take the tensor-core routes (flash_fwd_latent_sm90.cu,
// flash_fwd_pair_sm90.cu).
//
// Replaces the TPU kernel `_fwd_kernel` / `flash_fwd_bhtd` of the JAX package
// (src/repro/kernels/flash_attention.py:157, pallas_call at :252) at those
// shapes.  The one-D routes (flash_fwd.cu, flash_fwd_sm90.cu) take one D of
// 32, 64 or 128.
//
// Bound on the H100: operations.  One deepseek-v2-lite-16b prefill chunk
// (Tq 256 at q_offset 768, Tk 1024, 16 heads) does 2·(576 + 512) FLOPs for
// each of the 16 x 229,504 (row, key) pairs the causal mask allows (7.99
// GFLOP) over 1.2 MB of latent rows and 4.7 MB of q and o: 8.1 us at the
// bf16 tensor-core rate; float32 FMAs on the CUDA cores (67 TFLOP/s) take
// at least 0.12 ms.  The whole-prompt prefill (2 prompts of 4096, 16 heads)
// does 2·(192 + 128) FLOPs for each of 2.685e8 pairs: at least 2.6 ms on
// the CUDA cores.
//
// Design.  One 256-thread block per (16-row q tile, query head, batch row).
// The block stages its q tile once and loops over the 32-key tiles [lo, hi]
// of the host's block-sparse table (kernels/block_sparse.kv_block_bounds at
// 16 x 32 tiles), each tile's k (and v, unless v lies inside k) staged in
// shared memory with rows padded to DK + 4 floats (16-byte aligned,
// conflict-free float4 reads).  Thread (r, c) owns row r = tid / 16
// and keys c, c + 16 of the score tile (four FMA chains each), then output
// columns 4c + 64j .. 4c + 64j + 3 of row r.  When v is a prefix view of k
// (the latent pool's value view: same pointer and strides) the v tile is the
// k tile's first DV columns: nothing more is read or staged, and two blocks
// fit an SM.  The MaskSpec is evaluated element-wise only on edge tiles;
// NEG_INF handling is the reference's (an empty row: o = 0, lse = NEG_INF).
#include <cuda_runtime.h>

#include "flash_fwd_common.cuh"

namespace {

using repro_fwd::FwdParams;
using repro_fwd::Shape;
using repro_fwd::allowed;
using repro_fwd::kNegInf;

constexpr int BR = 16;   // q rows per tile
constexpr int BC = 32;   // keys per tile
constexpr int NT = 256;  // threads per block: 16 rows x 16 lanes

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Rows [0, n) of a (rows x D) tile from global rows at src + t·st, rows past
// `valid` zero-filled, into shared rows of `ss` floats.
template <int D>
__device__ __forceinline__ void stage(float* dst, int ss, const float* src,
                                      long long st, int n, int valid) {
  constexpr int CPR = D / 4;  // 4-element pieces a row
  for (int idx = threadIdx.x; idx < n * CPR; idx += NT) {
    const int i = idx / CPR, c = idx - i * CPR;
    const float4 a = i < valid ? load4(src + i * st + c * 4)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + i * ss + c * 4) = a;
  }
}

template <int DK, int DV>
constexpr size_t smem_bytes(bool v_in_k) {
  return sizeof(float) * (BR * (DK + 4) + BC * (DK + 4) +
                          (v_in_k ? 0 : BC * DV) + BR * (BC + 1)) +
         sizeof(int) * (BR + BC);
}

template <int DK, int DV>
__global__ void __launch_bounds__(NT)
    flash_fwd_latent_kernel(FwdParams a, int v_in_k) {
  static_assert(DK % 8 == 0 && DV % 64 == 0 && DV <= DK, "head dims");
  constexpr int KS = DK + 4;    // padded float row of sQ, sK
  constexpr int PP = BC + 1;
  constexpr int NV = DV / 64;   // float4 output pieces a thread
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + BR * KS;
  float* sV = v_in_k ? sK : sK + BC * KS;
  const int VS = v_in_k ? KS : DV;
  float* sP = v_in_k ? sK + BC * KS : sV + BC * DV;
  int* sQs = reinterpret_cast<int*>(sP + BR * PP);
  int* sKs = sQs + BR;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.group;
  const int tid = threadIdx.x;
  const int r = tid >> 4;   // the thread's row of the tile
  const int cl = tid & 15;  // its lane within the row
  const int q0 = qt * BR;
  const int lo = a.bounds[4 * qt], hi = a.bounds[4 * qt + 1];
  const int ilo = a.bounds[4 * qt + 2], ihi = a.bounds[4 * qt + 3];

  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;

  stage<DK>(sQ, KS, qb + q0 * a.q_st, a.q_st, BR, a.Tq - q0);
  if (a.has_seg && tid < BR) {
    const int t = q0 + tid;
    sQs[tid] = t < a.Tq ? a.qseg[b * a.qs_sb + t] : -1;
  }

  float m = kNegInf, l = 0.f;
  float4 acc[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int qp = a.q_offset + q0 + r;

  for (int j = lo; j <= hi; ++j) {
    const int k0 = j * BC;
    __syncthreads();  // the previous tile's sK / sV / sP are consumed
    stage<DK>(sK, KS, kb + k0 * a.k_st, a.k_st, BC, a.Tk - k0);
    if (!v_in_k) stage<DV>(sV, VS, vb + k0 * a.v_st, a.v_st, BC, a.Tk - k0);
    if (a.has_seg && tid < BC) {
      const int t = k0 + tid;
      sKs[tid] = t < a.Tk ? a.kseg[b * a.ks_sb + t] : -2;
    }
    __syncthreads();

    // scores of row r against keys cl and cl + 16, four chains each
    float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
    const float* qr = sQ + r * KS;
    const float* k0r = sK + cl * KS;
    const float* k1r = sK + (cl + 16) * KS;
#pragma unroll 4
    for (int d = 0; d < DK; d += 4) {
      const float4 q4 = load4(qr + d), x = load4(k0r + d), y = load4(k1r + d);
      s0[0] = fmaf(q4.x, x.x, s0[0]);
      s0[1] = fmaf(q4.y, x.y, s0[1]);
      s0[2] = fmaf(q4.z, x.z, s0[2]);
      s0[3] = fmaf(q4.w, x.w, s0[3]);
      s1[0] = fmaf(q4.x, y.x, s1[0]);
      s1[1] = fmaf(q4.y, y.y, s1[1]);
      s1[2] = fmaf(q4.z, y.z, s1[2]);
      s1[3] = fmaf(q4.w, y.w, s1[3]);
    }
    float s[2] = {(s0[0] + s0[1]) + (s0[2] + s0[3]),
                  (s1[0] + s1[1]) + (s1[2] + s1[3])};
    const bool edge = a.masked && (j < ilo || j > ihi);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int col = cl + 16 * jj;
      const int kl = k0 + col;
      bool ok = kl < a.Tk && q0 + r < a.Tq;
      if (ok && edge)
        ok = allowed(a, qp, a.kv_offset + kl, a.has_seg ? sQs[r] : 0,
                     a.has_seg ? sKs[col] : 0);
      s[jj] = ok ? s[jj] * a.scale : kNegInf;
    }

    // online softmax: the 16 lanes of a half-warp hold one row's 32 keys
    float mx = fmaxf(s[0], s[1]);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);
    const float m_safe = fmaxf(m_new, kNegInf * 0.5f);
    const bool dead = m_new <= kNegInf * 0.5f;
    float ps = 0.f;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const float p = dead ? 0.f : expf(s[jj] - m_safe);
      sP[r * PP + cl + 16 * jj] = p;
      ps += p;
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      ps += __shfl_xor_sync(0xffffffffu, ps, off);
    const float alpha = m <= kNegInf * 0.5f ? 0.f : expf(m - m_safe);
    l = alpha * l + ps;
    m = m_new;
#pragma unroll
    for (int jv = 0; jv < NV; ++jv) {
      acc[jv].x *= alpha;
      acc[jv].y *= alpha;
      acc[jv].z *= alpha;
      acc[jv].w *= alpha;
    }
    __syncwarp();  // a row's p is written by its own half-warp

#pragma unroll 4
    for (int kk = 0; kk < BC; ++kk) {
      const float p = sP[r * PP + kk];
      const float* vr = sV + kk * VS + 4 * cl;
#pragma unroll
      for (int jv = 0; jv < NV; ++jv) {
        const float4 v4 = load4(vr + 64 * jv);
        acc[jv].x = fmaf(p, v4.x, acc[jv].x);
        acc[jv].y = fmaf(p, v4.y, acc[jv].y);
        acc[jv].z = fmaf(p, v4.z, acc[jv].z);
        acc[jv].w = fmaf(p, v4.w, acc[jv].w);
      }
    }
  }

  const int t = q0 + r;
  if (t >= a.Tq) return;
  const float ls = l == 0.f ? 1.f : l;
  float* ob = static_cast<float*>(a.o) + b * a.o_sb + t * a.o_st + h * a.o_sh;
#pragma unroll
  for (int jv = 0; jv < NV; ++jv)
    *reinterpret_cast<float4*>(ob + 4 * cl + 64 * jv) =
        make_float4(acc[jv].x / ls, acc[jv].y / ls, acc[jv].z / ls,
                    acc[jv].w / ls);
  if (cl == 0)
    a.lse[((long long)b * a.Tq + t) * a.Hq + h] =
        l == 0.f ? kNegInf : m + logf(ls);
}

template <int DK, int DV>
cudaError_t launch(const FwdParams& p, int nq, int B, int v_in_k,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<DK, DV>(v_in_k != 0);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_latent_kernel<DK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  flash_fwd_latent_kernel<DK, DV>
      <<<dim3(nq, p.Hq, B), NT, smem, stream>>>(p, v_in_k);
  return cudaGetLastError();
}

}  // namespace

// Head dims (DK, DV) = (576, 512) or (192, 128), float32 (ia's dtype must
// be 0); ia as in flash_fwd_common.cuh with D = DK, then ia[29] = DV and
// ia[30] = 1 when v is a prefix view of k (same pointer and strides).  Rows
// must be 16-byte aligned.  Returns the CUDA error code of the launch (0 =
// launched).
extern "C" int repro_flash_fwd_latent(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      const void* bounds, const void* qseg,
                                      const void* kseg, const long long* ia,
                                      float scale, void* stream) {
  Shape sh;
  const FwdParams p = repro_fwd::parse(q, k, v, o, lse, bounds, qseg, kseg,
                                       ia, scale, &sh);
  const int dv = static_cast<int>(ia[29]);
  const int v_in_k = static_cast<int>(ia[30]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sh.dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (sh.D == 576 && dv == 512)
    return static_cast<int>(launch<576, 512>(p, sh.nq, sh.B, v_in_k, s));
  if (sh.D == 192 && dv == 128)
    return static_cast<int>(launch<192, 128>(p, sh.nq, sh.B, v_in_k, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

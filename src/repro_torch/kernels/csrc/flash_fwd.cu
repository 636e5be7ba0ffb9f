// Kernel A: FlashAttention-2 forward of one partial attention chunk, written
// by hand for Hopper (sm_90a), with a plain C entry point bound via ctypes.
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
// first version does its two products with float32 CUDA-core FMAs out of
// shared memory, so the FLOPs, not the bytes, set its time today; tensor-core
// `mma`/`wgmma`, TMA and warp specialisation are later work.  What the design
// does about the bound: every input is read once per q tile, no score tile
// reaches device memory, and the block-sparse table skips every KV tile the
// mask cannot reach.
//
// Design.  One thread block (256 threads) per (64-row q tile, query head,
// batch row).  The block loops over the 64-key tiles [lo, hi] that the
// wrapper computed on the host from the static MaskSpec
// (kernels/block_sparse.kv_block_bounds) and keeps the online-softmax state
// (m, l, o accumulator) in registers: thread (rg, cl) owns rows 4·rg..4·rg+3
// and key columns cl + 16·j of the score tile, and output columns cl + 16·j.
// The MaskSpec is evaluated element-wise only on edge tiles, those outside
// the interior range [ilo, ihi] (kernels/block_sparse.interior_kv_bounds).
// Tensors are read in the model's (B, T, H, D) layout through strides; ragged
// Tq and Tk are masked at the edge.  GQA maps query head h to kv head
// h / group.  NEG_INF handling reproduces the reference's m_safe / alpha rules
// (flash_attention.py:187-206): an empty row gives o = 0 and lse = NEG_INF.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int BR = 64;   // q rows per tile
constexpr int BC = 64;   // keys per tile
constexpr int NT = 256;  // threads per block

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  const int* bounds;  // (nq, 4): lo, hi, interior lo, interior hi
  const int* qseg;    // (B, Tq) segment ids, batch stride qs_sb (may be 0)
  const int* kseg;    // (B, Tk)
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;
  long long qs_sb, ks_sb;
  int Tq, Tk, Hq, group;
  int causal, window, prefix_len, q_offset, kv_offset, has_seg, masked;
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

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) *
             (BR * (D + 1) + BC * (D + 1) + BC * D + BR * (BC + 1)) +
         sizeof(int) * (BR + BC);
}

template <typename T, int D>
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

  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  for (int idx = tid; idx < BR * D; idx += NT) {
    const int i = idx / D, d = idx - i * D;
    const int t = q0 + i;
    sQ[i * DP + d] = t < a.Tq ? load_f(qb + t * a.q_st + d) : 0.f;
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
      sK[jj * DP + d] = ok ? load_f(kb + t * a.k_st + d) : 0.f;
      sV[jj * D + d] = ok ? load_f(vb + t * a.v_st + d) : 0.f;
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
        if (ok && edge) {
          const int kp = a.kv_offset + kl;
          const bool pre = a.prefix_len > 0 && kp < a.prefix_len;
          if (a.causal) ok = kp <= qp || pre;
          if (ok && a.window > 0) ok = qp - kp < a.window || pre;
          if (ok && a.has_seg) ok = sQs[row] == sKs[col] || pre;
        }
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
    T* ob = static_cast<T*>(a.o) + b * a.o_sb + t * a.o_st + h * a.o_sh;
#pragma unroll
    for (int dd = 0; dd < DV; ++dd) store_f(ob + cl + 16 * dd, acc[ii][dd] / ls);
    if (cl == 0)
      a.lse[((long long)b * a.Tq + t) * a.Hq + h] =
          l[ii] == 0.f ? kNegInf : m[ii] + logf(ls);
  }
}

template <typename T, int D>
cudaError_t launch(const FwdParams& p, int nq, int B, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  flash_fwd_kernel<T, D><<<dim3(nq, p.Hq, B), NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const FwdParams& p, int D, int nq, int B,
                       cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(p, nq, B, s);
    case 64: return launch<T, 64>(p, nq, B, s);
    case 128: return launch<T, 128>(p, nq, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// ia (int64): B, Tq, Tk, Hq, Hkv, D, dtype (0 f32, 1 bf16), nq,
//   q strides (b, t, h), k strides, v strides, o strides,
//   causal, window, prefix_len, q_offset, kv_offset, has_seg,
//   q-segment batch stride, kv-segment batch stride, masked.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, void* lse, const void* bounds,
                               const void* qseg, const void* kseg,
                               const long long* ia, float scale,
                               void* stream) {
  FwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.bounds = static_cast<const int*>(bounds);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  const int B = static_cast<int>(ia[0]);
  p.Tq = static_cast<int>(ia[1]);
  p.Tk = static_cast<int>(ia[2]);
  p.Hq = static_cast<int>(ia[3]);
  p.group = static_cast<int>(ia[3] / ia[4]);
  const int D = static_cast<int>(ia[5]);
  const int dtype = static_cast<int>(ia[6]);
  const int nq = static_cast<int>(ia[7]);
  p.q_sb = ia[8];  p.q_st = ia[9];  p.q_sh = ia[10];
  p.k_sb = ia[11]; p.k_st = ia[12]; p.k_sh = ia[13];
  p.v_sb = ia[14]; p.v_st = ia[15]; p.v_sh = ia[16];
  p.o_sb = ia[17]; p.o_st = ia[18]; p.o_sh = ia[19];
  p.causal = static_cast<int>(ia[20]);
  p.window = static_cast<int>(ia[21]);
  p.prefix_len = static_cast<int>(ia[22]);
  p.q_offset = static_cast<int>(ia[23]);
  p.kv_offset = static_cast<int>(ia[24]);
  p.has_seg = static_cast<int>(ia[25]);
  p.qs_sb = ia[26];
  p.ks_sb = ia[27];
  p.masked = static_cast<int>(ia[28]);
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = dispatch_d<float>(p, D, nq, B, s);
  else if (dtype == 1)
    e = dispatch_d<__nv_bfloat16>(p, D, nq, B, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

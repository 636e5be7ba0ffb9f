// Kernel B: paged flash-decode attention through a block table, written by
// hand for Hopper (sm_90a), with a plain C entry point bound via ctypes.
//
// Replaces the TPU kernel `_paged_kernel` / `paged_attn_pallas` of the JAX
// package (src/repro/kernels/paged.py:182, pallas_call at :266).
//
// Bound on the H100: bytes.  A decode step reads every attendable K and V
// row once (2·len·Hkv·D elements per request) and does only ~4·g·Tq·D FLOPs
// per row read, two orders of magnitude below the card's ridge point, so the
// least time is the K/V bytes over 3.35 TB/s.  What the design does about
// it: K and V are read straight from the (N, bs, Hkv, D) pools through the
// block table and strides, each attendable row exactly once per kv head and
// row group, with vector loads of a whole row per warp and no shared-memory
// staging or block-wide barrier in the sweep; the sweep covers only tokens
// [window start, lengths[b]).  The reference wrapper instead copied each
// layer's whole pool into (N, Hkv, bs, D) on every call (paged.py:242-243)
// and its grid walked all nb table entries (paged.py:249).  With one block
// per (kv head, request), a small batch of short requests leaves SMs idle;
// a split of the sequence across blocks is later work.
//
// Design.  One thread block (8 warps) per (kv head, request).  Query rows
// r = gi·Tq + t (query head hk·g + gi, token t at position
// lengths[b] − Tq + t) are taken four at a time and held in registers.
// Warp w walks tokens w, w + 8, ...: it looks up block_table[b, tok / bs]
// itself, loads the token's K and V rows (lane l holds elements
// [l·D/32, (l+1)·D/32)), reduces the q·k dot products across the warp, and
// folds them into its own float32 online softmax (m, l, o) in registers,
// with the reference's NEG_INF rules.  The eight warps' partial states are
// merged through shared memory at the end.  Rows with nothing attendable
// give o = 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int NW = 8;         // warps per block
constexpr int PT = 32 * NW;   // threads per block
constexpr int RG = 4;         // query rows held in registers per pass

struct PagedParams {
  const void* q;
  const void* kp;
  const void* vp;
  void* o;
  const int* table;    // (B, nb) block ids, batch stride t_sb
  const int* lengths;  // (B,)
  long long q_sb, q_st, q_sh;
  long long k_sn, k_ss, k_sh;
  long long v_sn, v_ss, v_sh;
  long long o_sb, o_st, o_sh;
  long long t_sb;
  int Tq, group, bs, nb, window;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// E consecutive elements at p (aligned to E·sizeof(T)) as float32.
template <typename T, int E>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[E]) {
  constexpr int BYTES = E * sizeof(T);
  T buf[E];
  if constexpr (BYTES == 16) {
    *reinterpret_cast<int4*>(buf) = *reinterpret_cast<const int4*>(p);
  } else if constexpr (BYTES == 8) {
    *reinterpret_cast<int2*>(buf) = *reinterpret_cast<const int2*>(p);
  } else if constexpr (BYTES == 4) {
    *reinterpret_cast<int*>(buf) = *reinterpret_cast<const int*>(p);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) buf[e] = p[e];
  }
#pragma unroll
  for (int e = 0; e < E; ++e) out[e] = to_f(buf[e]);
}

template <typename T, int D>
__global__ void __launch_bounds__(PT) paged_decode_kernel(PagedParams a) {
  constexpr int E = D / 32;  // elements per lane
  __shared__ float sM[NW * RG];
  __shared__ float sL[NW * RG];
  __shared__ float sAcc[NW * RG * D];

  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = a.group * a.Tq;
  const int len = a.lengths[b];
  const int t_hi = min(len, a.nb * a.bs);
  const int t_lo = a.window > 0 ? max(0, len - a.Tq - a.window + 1) : 0;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb;
  const T* kb = static_cast<const T*>(a.kp) + hk * a.k_sh + lane * E;
  const T* vb = static_cast<const T*>(a.vp) + hk * a.v_sh + lane * E;
  const int* tb = a.table + b * a.t_sb;

  for (int r0 = 0; r0 < R; r0 += RG) {
    const int nr = min(RG, R - r0);
    float qr[RG][E], m[RG], l[RG], acc[RG][E];
    int qpos[RG];
#pragma unroll
    for (int j = 0; j < RG; ++j) {
      const int r = r0 + (j < nr ? j : 0);
      const int gi = r / a.Tq, t = r - gi * a.Tq;
      load_vec<T, E>(qb + t * a.q_st + (hk * a.group + gi) * a.q_sh + lane * E,
                     qr[j]);
      qpos[j] = len - a.Tq + t;
      m[j] = kNegInf;
      l[j] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[j][e] = 0.f;
    }

    auto fold = [&](int tok, const float (&kv)[E], const float (&vv)[E]) {
#pragma unroll
      for (int j = 0; j < RG; ++j) {
        if (j >= nr) break;
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) x = fmaf(qr[j][e], kv[e], x);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, off);
        bool ok = tok <= qpos[j];
        if (a.window > 0) ok = ok && tok > qpos[j] - a.window;
        const float s = ok ? x * a.scale : kNegInf;
        const float m_new = fmaxf(m[j], s);
        const float m_safe = fmaxf(m_new, kNegInf * 0.5f);
        const float p = m_new <= kNegInf * 0.5f ? 0.f : expf(s - m_safe);
        const float alpha =
            m[j] <= kNegInf * 0.5f ? 0.f : expf(m[j] - m_safe);
        l[j] = alpha * l[j] + p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[j][e] = fmaf(alpha, acc[j][e], p * vv[e]);
        m[j] = m_new;
      }
    };

    // two tokens per trip keep four row loads in flight per warp
    for (int tok = t_lo + warp; tok < t_hi; tok += 2 * NW) {
      const int tok1 = tok + NW;
      const bool two = tok1 < t_hi;
      float k0[E], v0[E], k1[E], v1[E];
      {
        const long long blk = tb[tok / a.bs];
        const int s = tok - (tok / a.bs) * a.bs;
        load_vec<T, E>(kb + blk * a.k_sn + s * a.k_ss, k0);
        load_vec<T, E>(vb + blk * a.v_sn + s * a.v_ss, v0);
      }
      if (two) {
        const long long blk = tb[tok1 / a.bs];
        const int s = tok1 - (tok1 / a.bs) * a.bs;
        load_vec<T, E>(kb + blk * a.k_sn + s * a.k_ss, k1);
        load_vec<T, E>(vb + blk * a.v_sn + s * a.v_ss, v1);
      }
      fold(tok, k0, v0);
      if (two) fold(tok1, k1, v1);
    }

    // merge the warps' partial softmax states
#pragma unroll
    for (int j = 0; j < RG; ++j) {
      if (lane == 0) {
        sM[warp * RG + j] = m[j];
        sL[warp * RG + j] = l[j];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) sAcc[(warp * RG + j) * D + lane * E + e] = acc[j][e];
    }
    __syncthreads();
    T* ob = static_cast<T*>(a.o) + b * a.o_sb;
    for (int idx = tid; idx < nr * D; idx += PT) {
      const int j = idx / D, d = idx - j * D;
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sM[w * RG + j]);
      const float m_safe = fmaxf(mx, kNegInf * 0.5f);
      float lsum = 0.f, osum = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float mw = sM[w * RG + j];
        const float f = mw <= kNegInf * 0.5f ? 0.f : expf(mw - m_safe);
        lsum = fmaf(f, sL[w * RG + j], lsum);
        osum = fmaf(f, sAcc[(w * RG + j) * D + d], osum);
      }
      const int r = r0 + j;
      const int gi = r / a.Tq, t = r - gi * a.Tq;
      store_f(ob + t * a.o_st + (hk * a.group + gi) * a.o_sh + d,
              lsum == 0.f ? 0.f : osum / lsum);
    }
    __syncthreads();
  }
}

template <typename T, int D>
cudaError_t launch(const PagedParams& p, int Hkv, int B, cudaStream_t stream) {
  paged_decode_kernel<T, D><<<dim3(Hkv, B), PT, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const PagedParams& p, int D, int Hkv, int B,
                       cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(p, Hkv, B, s);
    case 64: return launch<T, 64>(p, Hkv, B, s);
    case 128: return launch<T, 128>(p, Hkv, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// ia (int64): B, Tq, Hq, Hkv, D, dtype (0 f32, 1 bf16), bs, nb, window,
//   q strides (b, t, h), k-pool strides (block, slot, head),
//   v-pool strides, o strides (b, t, h), table batch stride.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int repro_paged_decode(const void* q, const void* kp,
                                  const void* vp, void* o, const void* table,
                                  const void* lengths, const long long* ia,
                                  float scale, void* stream) {
  PagedParams p;
  p.q = q;
  p.kp = kp;
  p.vp = vp;
  p.o = o;
  p.table = static_cast<const int*>(table);
  p.lengths = static_cast<const int*>(lengths);
  const int B = static_cast<int>(ia[0]);
  p.Tq = static_cast<int>(ia[1]);
  const int Hkv = static_cast<int>(ia[3]);
  p.group = static_cast<int>(ia[2] / ia[3]);
  const int D = static_cast<int>(ia[4]);
  const int dtype = static_cast<int>(ia[5]);
  p.bs = static_cast<int>(ia[6]);
  p.nb = static_cast<int>(ia[7]);
  p.window = static_cast<int>(ia[8]);
  p.q_sb = ia[9];  p.q_st = ia[10]; p.q_sh = ia[11];
  p.k_sn = ia[12]; p.k_ss = ia[13]; p.k_sh = ia[14];
  p.v_sn = ia[15]; p.v_ss = ia[16]; p.v_sh = ia[17];
  p.o_sb = ia[18]; p.o_st = ia[19]; p.o_sh = ia[20];
  p.t_sb = ia[21];
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = dispatch_d<float>(p, D, Hkv, B, s);
  else if (dtype == 1)
    e = dispatch_d<__nv_bfloat16>(p, D, Hkv, B, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

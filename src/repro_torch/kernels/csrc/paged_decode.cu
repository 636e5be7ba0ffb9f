// Kernel B: paged flash-decode attention through a block table, written by
// hand for Hopper (sm_90a), with a plain C entry point bound via ctypes.
//
// Replaces the TPU kernel `_paged_kernel` / `paged_attn_pallas` of the JAX
// package (src/repro/kernels/paged.py:182, pallas_call at :266).
//
// Bound on the H100: bytes.  A decode step reads every attendable K and V
// row once (2·len·Hkv·D elements per request) and does ~4·g·Tq·D FLOPs per
// row read, two orders of magnitude below the card's ridge point, so the
// least time is the K/V bytes over 3.35 TB/s.  Reaching it takes (1) every
// SM busy, however few and uneven the requests, and (2) by Little's law,
// ~25 KB/µs × ~1 µs of latency ≈ 32 KB of reads in flight on each SM.
//
// What the design does about it (flash-decoding with a staged ring):
// - Split KV sweep.  Each request's context is cut into splits of L_s
//   tokens (a whole number of pages, chosen by the wrapper per head dim and
//   dtype: 256 for bf16 D = 128).  The grid is (Hkv · row groups, B, S),
//   S = ceil(nb · bs / L_s) from the table's width, so a long request
//   spreads over many SMs and a short one costs only its live splits: a
//   block whose split holds no attendable token exits at once.
// - Staging.  A block loads its split's block-table entries into shared
//   memory once, then streams the split in tiles of TT tokens (32 tokens,
//   8 KB of K and 8 KB of V, at bf16 D = 128) through a 4-stage ring filled
//   by 16-byte `cp.async` copies: three tiles, 48 KB, are in flight per
//   block while it works on the fourth, and three 256-thread blocks fit an
//   SM (144 KB in flight).  Of the shapes tried on an H100 (PERF.md),
//   2 stages of 32 KB were as fast and 3 stages of 32 KB (two blocks an
//   SM) slower at the serving step.  Tokens outside the
//   split's live range are zero-filled without a read, so the null block 0
//   and pages past the length are never touched.
// - Arithmetic on a staged tile.  Scores: LPS lanes per (row, token) pair,
//   16 bytes of the key row each (conflict-free shared reads), q held in
//   shared memory as float32 pre-scaled by scale · log2(e), a 3-step
//   shuffle sum.  Softmax: one warp per row takes one max and one sum per
//   tile (not per token), in the log2 domain, with the reference's NEG_INF
//   rules.  p · v: each thread owns two adjacent output columns of every
//   row of the block over every NLG-th token of the tile (NLG = 4 at
//   D = 128), float32 accumulators in registers, the token lanes summed in
//   a fixed order at the end; all g · Tq rows of a GQA group
//   share each staged tile, so K and V are read once per kv head.  Tensor
//   cores (mma.sync m16n8k16) would pay only once g · Tq ≥ 16, the
//   speculative-verify shape, and are not used.
// - Merge.  With one live split a request's block writes o itself; with
//   more, each split writes (o_s, lse_s) in float32 to the wrapper's scratch
//   and a second kernel merges them in a fixed order, as kernels/ref.merge_ref
//   does.  No atomics anywhere: split boundaries depend only on the
//   request's own positions, so a request's output is bitwise the same alone
//   or in any batch, under any block table, launch after launch.
//
// Latent shape (DeepSeek MLA, absorbed): q/k head dim DK = 576 (the kv_lora
// 512 latent ⊕ rope 64), v head dim DV = 512, one kv head under a group of 16
// query heads, and the value pool a prefix view of the key pool (the latent
// row's first 512 columns).  The kernel is templated on (DK, DV): a score
// takes 8 lanes over the row's 72 (bf16) or 144 (float32) 16-byte pieces;
// p · v gives each of the 256 threads one column pair of the 512 (NLG 1);
// the ring has 2 stages of 32 (bf16) or 16 (float32) tokens, 68 KB each,
// one block an SM.  When the value pool lies inside the key pool (same
// pointer and strides) only the latent rows are staged and V is read from
// their first DV columns: half the bytes.  Every query row of a GQA group
// (16 heads x Tq) shares each staged tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90_common.cuh"

namespace {

using repro_sm90::cp_async16;
using repro_sm90::cp_async_commit;
using repro_sm90::cp_async_wait;
using repro_sm90::kLog2e;
using repro_sm90::smem_u32;

constexpr float kNegInf = -1e30f;
constexpr int NT = 256;       // threads per block
constexpr int NW = NT / 32;   // warps per block
constexpr int RG = 16;        // most query rows (g · Tq) a block takes
constexpr int ST = 4;         // ring stages
constexpr int TILE_BYTES = 8192;    // K bytes a staged tile aims at
constexpr int MT = 512;       // threads of the merge kernel

struct PagedParams {
  const void* q;
  const void* kp;
  const void* vp;
  void* o;
  float* o_part;       // (B, S, Hq·Tq, D) float32, or null when S == 1
  float* lse_part;     // (B, S, Hq·Tq) float32, log2 domain
  const int* table;    // (B, nb) block ids, batch stride t_sb
  const int* lengths;  // (B,)
  long long q_sb, q_st, q_sh;
  long long k_sn, k_ss, k_sh;
  long long v_sn, v_ss, v_sh;
  long long o_sb, o_st, o_sh;
  long long t_sb;
  int Tq, group, bs, nb, window, Ls, S, n_rg, Hq;
  int v_in_k;          // the V pool is the K pool's first DV columns
  float qscale;        // scale · log2(e)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// The 16 bytes at p as float32 (8 bf16 or 4 float values).
__device__ __forceinline__ void chunk_f(const float* p, float (&out)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void chunk_f(const __nv_bfloat16* p,
                                        float (&out)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {      // a bf16 is a float's upper 16 bits
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Two consecutive elements at p (4- or 8-byte aligned) as float32.
__device__ __forceinline__ void pair_f(const float* p, float& x, float& y) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  x = v.x;
  y = v.y;
}
__device__ __forceinline__ void pair_f(const __nv_bfloat16* p, float& x,
                                       float& y) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  x = __uint_as_float(w << 16);
  y = __uint_as_float(w & 0xffff0000u);
}

// Compile-time shape of the split kernel for element type T, q/k head dim
// DK, v head dim DV and at most RM query rows a block (1, 4, or RG).
template <typename T, int DK, int DV, int RM>
struct Cfg {
  static constexpr int ESZ = sizeof(T);
  static constexpr bool LAT = DK != DV;           // the latent shape
  static constexpr int ROWB = DK * ESZ;           // bytes of one K row
  static constexpr int ROWV = DV * ESZ;           // bytes of one V row
  static constexpr int CPR = ROWB / 16;           // 16-byte chunks per K row
  static constexpr int CPRV = ROWV / 16;          // and per V row
  static constexpr int EPC = 16 / ESZ;            // elements per chunk
  static constexpr int TT =                       // tokens a tile
      LAT                       ? 512 / ESZ / 16  // 32 bf16, 16 float32
      : TILE_BYTES / ROWB < 32  ? 32
      : TILE_BYTES / ROWB > 128 ? 128
                                : TILE_BYTES / ROWB;
  static constexpr int ST = LAT ? 2 : 4;          // ring stages
  static constexpr int MINB = LAT ? 1 : 3;        // blocks an SM
  static constexpr int LPS = CPR < 8 ? CPR : 8;   // lanes per score
  static constexpr int CPL = CPR / LPS;           // chunks per lane
  static constexpr int NG = NT / LPS;             // score groups per block
  static constexpr int NCP = DV / 2;              // column pairs in p · v
  static constexpr int NLG = NT / NCP;            // token lanes in p · v
  static constexpr int STAGE = TT * (ROWB + ROWV);  // K tile then V tile
  static_assert(CPR % LPS == 0, "score lanes must divide a row");
  static_assert(LAT || (TT % NG == 0 && TT % 32 == 0),
                "tile must divide evenly");
  static_assert(NT % NCP == 0 && TT % NLG == 0, "p · v must divide evenly");
  static_assert(NLG * RM * DV * 4 <= ST * STAGE,
                "reduction must fit the ring");
};

// Dynamic shared memory of the split kernel: the ring, q, the tile's
// scores, the rows' (m, l, alpha) and the split's table entries.
template <typename T, int DK, int DV, int RM>
__host__ __device__ constexpr int smem_fixed() {
  using C = Cfg<T, DK, DV, RM>;
  return C::ST * C::STAGE + RM * DK * 4 + RM * C::TT * 4 + 3 * RM * 4;
}

// Live token range of request b: [t_lo, t_hi), and its live splits.
struct Live {
  int len, t_lo, t_hi, s_lo, s_hi;
};

__device__ __forceinline__ Live live_range(const PagedParams& a, int b) {
  Live L;
  L.len = a.lengths[b];
  L.t_hi = min(L.len, a.nb * a.bs);
  L.t_lo = a.window > 0 ? max(0, L.len - a.Tq - a.window + 1) : 0;
  if (L.t_hi > L.t_lo) {
    L.s_lo = L.t_lo / a.Ls;
    L.s_hi = (L.t_hi + a.Ls - 1) / a.Ls;
  } else {
    L.s_lo = L.s_hi = 0;
  }
  return L;
}

template <typename T, int DK, int DV, int RM>
__global__ void __launch_bounds__(NT, (Cfg<T, DK, DV, RM>::MINB))
    paged_decode_split_kernel(PagedParams a) {
  using C = Cfg<T, DK, DV, RM>;
  constexpr int TT = C::TT;
  constexpr int ST = C::ST;
  constexpr int D = DK;         // q and score width
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  float* sQ = reinterpret_cast<float*>(smem + ST * C::STAGE);   // RM × DK
  float* sS = sQ + RM * D;                                       // RM × TT
  float* sM = sS + RM * TT;
  float* sL = sM + RM;
  float* sA = sL + RM;
  int* sTab = reinterpret_cast<int*>(sA + RM);                   // Ls / bs

  const int hk = blockIdx.x / a.n_rg, rg = blockIdx.x - hk * a.n_rg;
  const int b = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = a.group * a.Tq;
  const int r0 = rg * RM, nr = min(RM, R - r0);
  // the split's table entries and q rows are loaded beside the length, so
  // the block waits on one round trip before its first copy
  const int P = a.Ls / a.bs, p0 = s * P;
  const int* tb = a.table + b * a.t_sb;
  const int tab = tid < P && p0 + tid < a.nb ? tb[p0 + tid] : 0;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb;
  constexpr int QPT = (RM * D + NT - 1) / NT;    // q elements per thread
  float qv[QPT];
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int i = tid + k * NT, r = i / D, c = i % D;
    qv[k] = 0.f;
    if (i < RM * D && r < nr) {
      const int gi = (r0 + r) / a.Tq, t = (r0 + r) - gi * a.Tq;
      qv[k] = to_f(qb[t * a.q_st + (hk * a.group + gi) * a.q_sh + c]);
    }
  }
  const Live L = live_range(a, b);
  const int lo = max(s * a.Ls, L.t_lo), hi = min((s + 1) * a.Ls, L.t_hi);
  const bool direct = L.s_hi - L.s_lo <= 1;   // this block writes o itself
  T* ob = static_cast<T*>(a.o) + b * a.o_sb;

  if (lo >= hi) {               // nothing attendable in this split
    if (L.s_hi == L.s_lo && s == 0) {   // nor in the request: o = 0
      for (int i = tid; i < nr * DV; i += NT) {
        const int r = r0 + i / DV, c = i % DV;
        const int gi = r / a.Tq, t = r - gi * a.Tq;
        store_f(ob + t * a.o_st + (hk * a.group + gi) * a.o_sh + c, 0.f);
      }
    }
    return;
  }

  // table entries, q rows (pre-scaled), softmax state into shared memory
  if (tid < P) sTab[tid] = tab;
#pragma unroll
  for (int k = 0; k < QPT; ++k)
    if (tid + k * NT < RM * D) sQ[tid + k * NT] = qv[k] * a.qscale;
  if (tid < RM) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }

  // tiles of TT tokens anchored at the split's start
  const int base = s * a.Ls;
  const int n0 = (lo - base) / TT, n1 = (hi - base + TT - 1) / TT;
  const int ntiles = n1 - n0;
  const T* kb = static_cast<const T*>(a.kp) + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.vp) + hk * a.v_sh;
  const uint32_t ring_u = smem_u32(ring);

  const bool v_in_k = a.v_in_k;
  auto load_tile = [&](int n) {
    const uint32_t dk = ring_u + (n % ST) * C::STAGE;
    const uint32_t dv = dk + TT * C::ROWB;
    const int t0 = base + (n0 + n) * TT;
    for (int idx = tid; idx < TT * C::CPR; idx += NT) {
      const int j = idx / C::CPR, c = idx - j * C::CPR;
      const int tok = t0 + j;
      const bool ok = tok >= lo && tok < hi;
      const T* ks = kb;
      const T* vs = vb;
      if (ok) {
        const int pg = tok / a.bs;
        const long long blk = sTab[pg - p0];
        const int slot = tok - pg * a.bs;
        ks = kb + blk * a.k_sn + slot * a.k_ss + c * C::EPC;
        vs = vb + blk * a.v_sn + slot * a.v_ss + c * C::EPC;
      }
      cp_async16(dk + j * C::ROWB + c * 16, ks, ok);
      if (!v_in_k && c < C::CPRV)
        cp_async16(dv + j * C::ROWV + c * 16, vs, ok);
    }
  };

  float acc[RM][2];
#pragma unroll
  for (int i = 0; i < RM; ++i) acc[i][0] = acc[i][1] = 0.f;
  // p · v: thread (column pair cp, token lane tl)
  const int cp = tid % C::NCP, tl = tid / C::NCP, col = 2 * cp;

  __syncthreads();              // sTab, sQ, sM, sL ready
#pragma unroll
  for (int n = 0; n < ST - 1; ++n) {
    if (n < ntiles) load_tile(n);
    cp_async_commit();
  }

  for (int n = 0; n < ntiles; ++n) {
    cp_async_wait<ST - 2>();
    __syncthreads();            // tile n landed; tile n-1's stage is free
    if (n + ST - 1 < ntiles) load_tile(n + ST - 1);
    cp_async_commit();

    const unsigned char* kt = ring + (n % ST) * C::STAGE;
    // V rows: the staged V tile, or the K tile's first DV columns
    const T* vt = reinterpret_cast<const T*>(v_in_k ? kt
                                                    : kt + TT * C::ROWB);
    const int vrow = v_in_k ? DK : DV;
    const int t0 = base + (n0 + n) * TT;

    // scores, log2 domain: LPS lanes per (row, token)
    {
      const int grp = tid / C::LPS, sub = tid % C::LPS;
      for (int p = grp; p < nr * TT; p += C::NG) {
        const int r = p / TT, j = p - r * TT;
        float xs[4] = {0.f, 0.f, 0.f, 0.f};   // four independent chains
#pragma unroll
        for (int i = 0; i < C::CPL; ++i) {
          const int c = sub + i * C::LPS;
          float kf[C::EPC];
          chunk_f(reinterpret_cast<const T*>(kt + j * C::ROWB + c * 16), kf);
          const float* qr = sQ + r * D + c * C::EPC;
#pragma unroll
          for (int e = 0; e < C::EPC; e += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qr + e);
            xs[0] = fmaf(q4.x, kf[e], xs[0]);
            xs[1] = fmaf(q4.y, kf[e + 1], xs[1]);
            xs[2] = fmaf(q4.z, kf[e + 2], xs[2]);
            xs[3] = fmaf(q4.w, kf[e + 3], xs[3]);
          }
        }
        float x = (xs[0] + xs[1]) + (xs[2] + xs[3]);
#pragma unroll
        for (int off = C::LPS / 2; off > 0; off >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, off);
        if (sub == 0) {
          const int tok = t0 + j;
          const int qpos = L.len - a.Tq + (r0 + r) % a.Tq;
          bool ok = tok >= lo && tok < hi && tok <= qpos;
          if (a.window > 0) ok = ok && tok > qpos - a.window;
          sS[r * TT + j] = ok ? x : kNegInf;
        }
      }
    }
    __syncthreads();

    // one max and one sum per row and tile
    constexpr int NPL = (TT + 31) / 32;    // tokens a lane
    for (int r = warp; r < nr; r += NW) {
      float sv[NPL];
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        sv[i] = i * 32 + lane < TT ? sS[r * TT + i * 32 + lane] : kNegInf;
        mx = fmaxf(mx, sv[i]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      const bool empty = m_new <= kNegInf * 0.5f;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        if (i * 32 + lane >= TT) continue;
        const float p = empty ? 0.f : exp2f(sv[i] - m_new);
        sS[r * TT + i * 32 + lane] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha =
            m_old <= kNegInf * 0.5f ? 0.f : exp2f(m_old - m_new);
        sA[r] = alpha;
        sL[r] = alpha * sL[r] + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // p · v: thread (column pair, token lane) over tokens tl, tl + NLG, ...
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      if (r < nr) {
        acc[r][0] *= sA[r];
        acc[r][1] *= sA[r];
      }
    }
#pragma unroll 4
    for (int j = tl; j < TT; j += C::NLG) {
      float v0, v1;
      pair_f(vt + j * vrow + col, v0, v1);
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        if (r < nr) {
          const float pr = sS[r * TT + j];
          acc[r][0] = fmaf(pr, v0, acc[r][0]);
          acc[r][1] = fmaf(pr, v1, acc[r][1]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // sum the token lanes' partials in a fixed order (through the ring)
  float* red = reinterpret_cast<float*>(ring);     // NLG × RM × DV
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    if (r < nr) {
      red[(tl * RM + r) * DV + col] = acc[r][0];
      red[(tl * RM + r) * DV + col + 1] = acc[r][1];
    }
  }
  __syncthreads();
  const int RT = a.Hq * a.Tq;
  for (int i = tid; i < nr * DV; i += NT) {
    const int r = i / DV, c = i - r * DV;
    float x = red[r * DV + c];
    for (int w = 1; w < C::NLG; ++w) x += red[(w * RM + r) * DV + c];
    const float l = sL[r];
    const float val = l == 0.f ? 0.f : x / l;
    const int rr = r0 + r;
    if (direct) {
      const int gi = rr / a.Tq, t = rr - gi * a.Tq;
      store_f(ob + t * a.o_st + (hk * a.group + gi) * a.o_sh + c, val);
    } else {
      const long long row = (static_cast<long long>(b) * a.S + s) * RT +
                            hk * R + rr;
      a.o_part[row * DV + c] = val;
      if (c == 0) a.lse_part[row] = l == 0.f ? kNegInf : sM[r] + log2f(l);
    }
  }
}

// Merges the live splits' (o_s, lse_s) of one (request, query head, token)
// row; requests with at most one live split were written by the split
// kernel.  Thread (col, sl) takes splits s_lo + sl, s_lo + sl + SL, ...; the
// SL lanes' partial sums are added in lane order, so the order of every
// sum depends only on the request's live splits.
template <typename T, int D>
__global__ void __launch_bounds__(MT) paged_decode_merge_kernel(PagedParams a) {
  constexpr int SL = MT / D;
  __shared__ float sMax[SL], sDen[SL], sNum[SL * D];
  const int row = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int col = tid % D, sl = tid / D;
  const Live L = live_range(a, b);
  if (L.s_hi - L.s_lo <= 1) return;
  const int RT = a.Hq * a.Tq;
  const long long rb = static_cast<long long>(b) * a.S * RT + row;
  float mx = kNegInf;
#pragma unroll 4
  for (int s = L.s_lo + sl; s < L.s_hi; s += SL)
    mx = fmaxf(mx, a.lse_part[rb + static_cast<long long>(s) * RT]);
  if (col == 0) sMax[sl] = mx;
  __syncthreads();
  mx = sMax[0];
  for (int w = 1; w < SL; ++w) mx = fmaxf(mx, sMax[w]);
  float num = 0.f, den = 0.f;
  if (mx > kNegInf * 0.5f) {
#pragma unroll 4
    for (int s = L.s_lo + sl; s < L.s_hi; s += SL) {
      const long long i = rb + static_cast<long long>(s) * RT;
      const float ls = a.lse_part[i];
      const float w = ls <= kNegInf * 0.5f ? 0.f : exp2f(ls - mx);
      den += w;
      num = fmaf(w, a.o_part[i * D + col], num);
    }
  }
  sNum[sl * D + col] = num;
  if (col == 0) sDen[sl] = den;
  __syncthreads();
  if (sl != 0) return;
  for (int w = 1; w < SL; ++w) {
    num += sNum[w * D + col];
    den += sDen[w];
  }
  const int hq = row / a.Tq, t = row - hq * a.Tq;
  T* ob = static_cast<T*>(a.o) + b * a.o_sb;
  store_f(ob + t * a.o_st + hq * a.o_sh + col, den == 0.f ? 0.f : num / den);
}

template <typename T, int DK, int DV, int RM>
cudaError_t launch_split(PagedParams& p, int Hkv, int B, cudaStream_t stream) {
  const int smem = smem_fixed<T, DK, DV, RM>() + (p.Ls / p.bs) * 4;
  const cudaError_t e = cudaFuncSetAttribute(
      paged_decode_split_kernel<T, DK, DV, RM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  p.n_rg = (p.group * p.Tq + RM - 1) / RM;
  paged_decode_split_kernel<T, DK, DV, RM>
      <<<dim3(Hkv * p.n_rg, B, p.S), NT, smem, stream>>>(p);
  return cudaGetLastError();
}

// Rows a block takes: 1 (a plain decode), 4, or RG; fewer rows than the
// block serves would cost guarded work on every staged tile.  The latent
// shape (a group of 16 heads: 16 rows a token) always takes RG.
template <typename T, int DK, int DV>
cudaError_t launch(PagedParams p, int Hkv, int B, cudaStream_t stream) {
  const int R = p.group * p.Tq;
  cudaError_t e;
  if constexpr (DK != DV)
    e = launch_split<T, DK, DV, RG>(p, Hkv, B, stream);
  else
    e = R == 1   ? launch_split<T, DK, DV, 1>(p, Hkv, B, stream)
        : R <= 4 ? launch_split<T, DK, DV, 4>(p, Hkv, B, stream)
                 : launch_split<T, DK, DV, RG>(p, Hkv, B, stream);
  if (e != cudaSuccess || p.S == 1) return e;
  paged_decode_merge_kernel<T, DV>
      <<<dim3(p.Hq * p.Tq, B), MT, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const PagedParams& p, int DK, int DV, int Hkv, int B,
                       cudaStream_t s) {
  if (DK == 576 && DV == 512) return launch<T, 576, 512>(p, Hkv, B, s);
  if (DK != DV) return cudaErrorInvalidValue;
  switch (DK) {
    case 32: return launch<T, 32, 32>(p, Hkv, B, s);
    case 64: return launch<T, 64, 64>(p, Hkv, B, s);
    case 128: return launch<T, 128, 128>(p, Hkv, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// ia (int64): B, Tq, Hq, Hkv, D (of q and k), dtype (0 f32, 1 bf16), bs,
//   nb, window, q strides (b, t, h), k-pool strides (block, slot, head),
//   v-pool strides, o strides (b, t, h), table batch stride,
//   split length L_s (tokens, a multiple of bs), splits S, Dv (of v and o;
//   equal to D, or 512 at D 576), and 1 when the v pool is the k pool's
//   first Dv columns (same pointer and strides), else 0.
// o_part / lse_part: float32 scratch (B, S, Hq·Tq, Dv) / (B, S, Hq·Tq),
// null when S == 1.  Returns the CUDA error code of the launches (0 =
// launched).
extern "C" int repro_paged_decode(const void* q, const void* kp,
                                  const void* vp, void* o, void* o_part,
                                  void* lse_part, const void* table,
                                  const void* lengths, const long long* ia,
                                  float scale, void* stream) {
  PagedParams p;
  p.q = q;
  p.kp = kp;
  p.vp = vp;
  p.o = o;
  p.o_part = static_cast<float*>(o_part);
  p.lse_part = static_cast<float*>(lse_part);
  p.table = static_cast<const int*>(table);
  p.lengths = static_cast<const int*>(lengths);
  const int B = static_cast<int>(ia[0]);
  p.Tq = static_cast<int>(ia[1]);
  p.Hq = static_cast<int>(ia[2]);
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
  p.Ls = static_cast<int>(ia[22]);
  p.S = static_cast<int>(ia[23]);
  const int DV = static_cast<int>(ia[24]);
  p.v_in_k = static_cast<int>(ia[25]);
  p.qscale = scale * kLog2e;
  if (p.Ls <= 0 || p.Ls % p.bs || p.Ls / p.bs > NT || p.S < 1 ||
      (p.S > 1 && !o_part))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = dispatch_d<float>(p, D, DV, Hkv, B, s);
  else if (dtype == 1)
    e = dispatch_d<__nv_bfloat16>(p, D, DV, Hkv, B, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

// Kernel A, latent route, bf16: the FlashAttention-2 forward of one partial
// attention chunk whose q/k head dim (576) differs from v's (512), on
// Hopper's tensor cores (sm_90a `wgmma`), written by hand, with a plain C
// entry point bound via ctypes.  It serves absorbed multi-head latent
// attention (DeepSeek MLA): q/k rows are the kv_lora 512 latent ⊕ rope 64,
// one latent kv head sits under a group of query heads, and v is the first
// 512 columns of k (a strided view) or a tensor of its own.  float32 inputs
// take the CUDA-core route (flash_fwd_latent.cu).
//
// Replaces the TPU kernel `_fwd_kernel` / `flash_fwd_bhtd` of the JAX
// package (src/repro/kernels/flash_attention.py:157, pallas_call at :252,
// where Dv may differ from Dk) at that shape.
//
// Bound on the H100: operations.  One deepseek-v2-lite-16b prefill chunk
// (Tq 256 at q_offset 768, Tk 1024, 16 heads) does 2·(576 + 512) FLOPs for
// each of the 16 × 229,504 (row, key) pairs the causal mask allows (7.99
// GFLOP) over 1.2 MB of latent rows and 4.7 MB of q and o: 8.1 us at the
// bf16 tensor-core rate.
//
// Design.  The rows of a tile are (position, head) pairs of one kv head's
// group, position-major: 64 rows are 64 / G positions × G heads (a group G
// that divides 64), or 64 heads of one position (G a multiple of 64).  Every
// head of the group reads the same latent rows, so each k tile is staged
// once for all of them (the CUDA-core route staged it once a head).  One
// block of two warpgroups (256 threads) per (64-row tile, kv head, batch
// row), heaviest position tiles first.
//   Loads.  Thread 0 requests the q tile once by TMA (nine 64-column slabs,
//   each a box of 64 columns × heads × positions that lands as 64 rows of
//   128 bytes in the 128-byte-swizzled layout `wgmma` reads; rows past Tq
//   arrive as zeros), and the position tile's BC-key tiles [lo, hi] (the
//   wrapper's host table, kernels/block_sparse.kv_block_bounds at 64 / G
//   positions × BC keys) through a ring of two stages with `full` / `empty`
//   `mbarrier`s.  When v is k's prefix view (same pointer and strides) the
//   v tile is the staged k tile's first 8 of its 9 slabs and nothing more is
//   read: BC = 64 (q 72 KiB + 2 × 72 KiB).  A v of its own is staged beside
//   k: BC = 32 (q 72 KiB + 2 × (36 + 32) KiB).  Tile n + 1 is requested
//   while the products of tile n run, once both warpgroups have released
//   tile n − 1.
//   Products.  A 64 × 512 float32 o accumulator is 256 registers a thread
//   for one warpgroup, so warpgroup w owns o's columns 256w .. 256w + 255
//   (128 registers).  Both warpgroups compute the same s = q·kᵀ (36 k16
//   steps of `wgmma` m64nBCk16, both operands in shared memory, K-major)
//   and the same online softmax, in float32 registers in the log2 domain
//   with the mask only on edge tiles (outside the table's interior range,
//   or past a ragged Tk), so p stays in registers as the A operand of
//   o += p·v (`wgmma` m64n128k16, v MN-major) and no warpgroup waits for
//   the other.  That repeats s: 2·(2·576 + 2·512) tensor FLOPs a (row, key)
//   pair against the bound's 2·(576 + 512).  (Handing p from one warpgroup
//   to the other through shared memory would not repeat s, but p's 16 KiB
//   does not fit beside q and two 64-key stages.)
//   Split.  The serving chunk has 64 tiles for 132 SMs, so the wrapper may
//   cut each tile's sweep into nsplit parts (kernels/flash_attention.py,
//   latent_splits): each block writes its part's normalised o (float32)
//   and lse, and a merge kernel combines them in part order.  Deterministic:
//   no atomics, a fixed order of every sum.
//   p goes in as two bf16 terms, hi = bf16(p) and lo = bf16(p − hi), into
//   one accumulator: with one term the serving chunk misses the
//   element-wise bar (3e-2 of each output) by 8×, with two it reads 7.7e-3
//   (a CPU emulation of this arithmetic, tests/test_torch_kernels.py).
// NEG_INF handling reproduces the reference's m_safe / alpha rules
// (flash_attention.py:187-206): an empty row gives o = 0 and lse = NEG_INF.
// lse is written in float32, (B, Tq, Hq).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_fwd_common.cuh"
#include "sm90_common.cuh"
#include "sm90_tma.cuh"

namespace {

using repro_fwd::FwdParams;
using repro_fwd::Shape;
using repro_fwd::allowed;
using repro_fwd::kNegInf;
using namespace repro_sm90;

constexpr int DK = 576, DV = 512;  // q/k and v head dims
constexpr int KSL = DK / 64;       // 64-column slabs of a q or k tile
constexpr int VSL = DV / 64;       // of a v tile
constexpr int kRows = 64;          // (position, head) rows a tile
constexpr int kStages = 2;         // kv tiles in the shared-memory ring
constexpr int kThreads = 256;      // two warpgroups
constexpr uint32_t kQBytes = KSL * kRows * 128;

// Keys a kv tile: 64 when v is k's prefix view, 32 when it is staged beside
// k (two stages of both must fit beside the q tile).
template <bool VOWN>
__host__ __device__ constexpr int keys() {
  return VOWN ? 32 : 64;
}

template <bool VOWN>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return (KSL + (VOWN ? VSL : 0)) * keys<VOWN>() * 128;
}

// The q tile, kStages stages, 2·kStages + 1 mbarriers, and room to align
// the start to 1024 bytes.
template <bool VOWN>
constexpr size_t latent_smem_bytes() {
  return kQBytes + kStages * stage_bytes<VOWN>() + (2 * kStages + 1) * 8 +
         1024;
}

// How a 64-row tile covers a group of G query heads: hg heads × 64 / hg
// positions, nhc tiles across the group's heads at one position tile; and
// the kv sweep of each tile cut into nsplit parts, whose partial o (float32,
// normalised) and lse go to o_part (nsplit, B, Tq, Hq, DV) and lse_part
// (nsplit, B, Tq, Hq) for the merge kernel when nsplit > 1.
struct Tiling {
  int hg, pg, nhc, nsplit;
  float* o_part;
  float* lse_part;
};

// d (64 × 32, float32) += A · B, both operands in shared memory, K-major.
__device__ __forceinline__ void mma_ss_n32(float (&d)[16], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void mma_ss_keys(float (&d)[32], uint64_t da,
                                            uint64_t db) {
  mma_ss(d, da, db);
}

__device__ __forceinline__ void mma_ss_keys(float (&d)[16], uint64_t da,
                                            uint64_t db) {
  mma_ss_n32(d, da, db);
}

// ---------------------------------------------------------------- kernel

template <bool VOWN>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_latent_wgmma_kernel(const FwdParams a, const Tiling tl,
                                  const __grid_constant__ CUtensorMap tmq,
                                  const __grid_constant__ CUtensorMap tmk,
                                  const __grid_constant__ CUtensorMap tmv) {
  constexpr int BC = keys<VOWN>();
  constexpr int NS = BC / 2;   // score entries a thread: 64 × BC / 128
  constexpr int KK = BC / 16;  // k16 steps of o += p·v
  constexpr uint32_t SB = stage_bytes<VOWN>();
  constexpr uint32_t KB = KSL * BC * 128;  // bytes of a k tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sKV = sQ + kQBytes;  // stage s at sKV + s·SB: k, then v
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kQBytes +
                                               kStages * SB);
  uint64_t* empty = full + kStages;
  uint64_t* qfull = empty + kStages;

  const int tile = blockIdx.x / tl.nsplit, part = blockIdx.x % tl.nsplit;
  const int npt = gridDim.x / (tl.nhc * tl.nsplit);
  const int pt = npt - 1 - tile / tl.nhc;  // heaviest first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int t0 = pt * tl.pg;                                 // position
  const int h0 = hk * a.group + (tile % tl.nhc) * tl.hg;     // q head
  const int tid = threadIdx.x;
  // this block's part of the table's sweep [lo, hi]
  const int lo0 = a.bounds[4 * pt], hi0 = a.bounds[4 * pt + 1];
  const int per = (max(hi0 - lo0 + 1, 0) + tl.nsplit - 1) / tl.nsplit;
  const int lo = lo0 + part * per, hi = min(hi0, lo + per - 1);
  const int ntiles = hi >= lo ? hi - lo + 1 : 0;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kThreads);
    }
    mbar_init(qfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Kv tile n into stage n % kStages: k slab by slab (BC rows × 64
  // columns a box, rows past Tk zero-filled), then v's when it has its own.
  auto load_kv = [&](int n) {
    const int s = n % kStages, k0 = (lo + n) * BC;
    const uint32_t kt = sKV + s * SB;
    mbar_expect_tx(full + s, SB);
#pragma unroll
    for (int c = 0; c < KSL; ++c)
      tma_load_4d(kt + c * (BC * 128), &tmk, 64 * c, hk, k0, b, full + s);
    if constexpr (VOWN) {
#pragma unroll
      for (int c = 0; c < VSL; ++c)
        tma_load_4d(kt + KB + c * (BC * 128), &tmv, 64 * c, hk, k0, b,
                    full + s);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(qfull, kQBytes);
#pragma unroll
    for (int c = 0; c < KSL; ++c)
      tma_load_4d(sQ + c * (kRows * 128), &tmq, 64 * c, h0, t0, b, qfull);
    for (int n = 0; n < kStages - 1 && n < ntiles; ++n) load_kv(n);
  }

  const int w = tid >> 7, t128 = tid & 127;
  const int warp = t128 >> 5, lane = tid & 31;
  // This thread's accumulator rows (of the tile's 64): rr and rr + 8, each
  // a (position, head) pair; its columns in each 8-column group: c0, c0 + 1.
  const int c0 = 2 * (lane & 3);
  const float scale2 = a.scale * kLog2e;
  const int ilo = a.bounds[4 * pt + 2], ihi = a.bounds[4 * pt + 3];
  int pos[2], head[2], qp[2], qs[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + (lane >> 2) + 8 * r;
    pos[r] = t0 + row / tl.hg;
    head[r] = h0 + row % tl.hg;
    qp[r] = a.q_offset + pos[r];
    qs[r] = a.has_seg && pos[r] < a.Tq ? a.qseg[b * a.qs_sb + pos[r]] : -1;
  }

  float m[2] = {kNegInf, kNegInf};  // running max, log2 units
  float l[2] = {0.f, 0.f};          // this thread's part of the row sums
  float acc[4][32];                 // o's columns 256w + 64c + ...
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;

  mbar_wait(qfull, 0);

  for (int n = 0; n < ntiles; ++n) {
    const int s = n % kStages;
    const int j = lo + n, k0 = j * BC;
    const uint32_t kt = sKV + s * SB;
    const uint32_t vt = VOWN ? kt + KB : kt;  // v's slab c at vt + c·BC·128
    mbar_wait(full + s, (n / kStages) & 1);

    float sc[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = 0.f;
    fence_regs(sc);  // written before the fence, not sunk past it
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4 * KSL; ++ks)
      mma_ss_keys(sc, kmajor<kRows>(sQ, ks), kmajor<BC>(kt, ks));
    wg_commit();

    // While s is in flight: request tile n + kStages − 1 into the stage
    // tile n − 1 used, once both warpgroups have released it.
    if (tid == 0 && n + kStages - 1 < ntiles) {
      if (n >= 1) mbar_wait(empty + (n - 1) % kStages, ((n - 1) / kStages) & 1);
      load_kv(n + kStages - 1);
    }
    wg_wait<0>();
    fence_regs(sc);

    // scale into log2 units, then mask (edge tiles only)
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] *= scale2;
    const bool edge = (a.masked && (j < ilo || j > ihi)) || k0 + BC > a.Tk;
    if (edge) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int r = (i >> 1) & 1;
        const int kl = k0 + 8 * (i >> 2) + c0 + (i & 1);
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
    for (int i = 0; i < NS; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = exp2_approx(sc[i] - mb[r]);
      l[r] += sc[i];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] *= alpha[(i >> 1) & 1];

    // p as two bf16 terms, hi + lo: the A fragments of o += p·v, 16 keys a
    // k16 step (the accumulator layout of s is the A fragment layout)
    uint32_t ph[KK][4], pl[KK][4];
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int i = 8 * kk + 2 * f;
        const __nv_bfloat162 hv = __floats2bfloat162_rn(sc[i], sc[i + 1]);
        const float2 hf = __bfloat1622float2(hv);
        ph[kk][f] = *reinterpret_cast<const uint32_t*>(&hv);
        pl[kk][f] = pack_bf16(sc[i] - hf.x, sc[i + 1] - hf.y);
      }
    // this warpgroup's 256 columns of v: slabs 4w .. 4w + 3, two at a time
    // (acc's rescaling and p's terms are pinned before the fence)
#pragma unroll
    for (int c = 0; c < 4; ++c) fence_regs(acc[c]);
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      fence_regs(ph[kk]);
      fence_regs(pl[kk]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const uint64_t dv = sw128_desc(
            vt + (4 * w + 2 * h2) * (BC * 128) + kk * 2048, BC * 128, 1024);
        mma_rs_n128(acc[2 * h2], acc[2 * h2 + 1], ph[kk], dv);
        mma_rs_n128(acc[2 * h2], acc[2 * h2 + 1], pl[kk], dv);
      }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int c = 0; c < 4; ++c) fence_regs(acc[c]);
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      fence_regs(ph[kk]);
      fence_regs(pl[kk]);
    }
    mbar_arrive(empty + s);  // this thread no longer reads stage s
  }

  // o = acc / l for this warpgroup's columns; lse = m + log l (warpgroup
  // 0): into o and lse, or into this part's slices of o_part and lse_part
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv = lt == 0.f ? 1.f : 1.f / lt;
    if (pos[r] >= a.Tq) continue;
    const long long row = (static_cast<long long>(part) * gridDim.z + b) *
                              a.Tq * a.Hq +
                          static_cast<long long>(pos[r]) * a.Hq + head[r];
    if (tl.nsplit == 1) {
      bf16* orow = static_cast<bf16*>(a.o) + b * a.o_sb + pos[r] * a.o_st +
                   head[r] * a.o_sh + 256 * w;
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int i = 2 * r; i < 32; i += 4)
          *reinterpret_cast<__nv_bfloat162*>(orow + 64 * c + 8 * (i >> 2) +
                                             c0) =
              __floats2bfloat162_rn(acc[c][i] * inv, acc[c][i + 1] * inv);
    } else {
      float* orow = tl.o_part + row * DV + 256 * w;
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int i = 2 * r; i < 32; i += 4)
          *reinterpret_cast<float2*>(orow + 64 * c + 8 * (i >> 2) + c0) =
              make_float2(acc[c][i] * inv, acc[c][i + 1] * inv);
    }
    if (w == 0 && (lane & 3) == 0)
      (tl.nsplit == 1 ? a.lse : tl.lse_part)[row] =
          lt == 0.f ? kNegInf : m[r] * kLn2 + logf(lt);
  }
}

// Merges the nsplit partial (o, lse) of one (batch row, position, head) row
// in part order: o = Σ e^(lse_s − M) o_s / Σ e^(lse_s − M), lse = M +
// log Σ e^(lse_s − M) with M the largest lse_s; a row no part saw gives
// o = 0 and lse = NEG_INF.  128 threads a row, 4 columns each.
__global__ void __launch_bounds__(128)
    flash_fwd_latent_merge_kernel(const FwdParams a, const Tiling tl) {
  const long long rows = static_cast<long long>(gridDim.y) * a.Tq * a.Hq;
  const long long row = static_cast<long long>(blockIdx.y) * a.Tq * a.Hq +
                        blockIdx.x;
  const int col = 4 * threadIdx.x;
  float mx = kNegInf;
  for (int s = 0; s < tl.nsplit; ++s)
    mx = fmaxf(mx, tl.lse_part[s * rows + row]);
  float den = 0.f;
  float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
  if (mx > kNegInf * 0.5f)
    for (int s = 0; s < tl.nsplit; ++s) {
      const float ls = tl.lse_part[s * rows + row];
      const float wt = ls <= kNegInf * 0.5f ? 0.f : expf(ls - mx);
      const float4 x = *reinterpret_cast<const float4*>(
          tl.o_part + (s * rows + row) * DV + col);
      den += wt;
      num.x = fmaf(wt, x.x, num.x);
      num.y = fmaf(wt, x.y, num.y);
      num.z = fmaf(wt, x.z, num.z);
      num.w = fmaf(wt, x.w, num.w);
    }
  const float inv = den == 0.f ? 0.f : 1.f / den;
  const int t = blockIdx.x / a.Hq, h = blockIdx.x - t * a.Hq;
  bf16* orow = static_cast<bf16*>(a.o) + blockIdx.y * a.o_sb + t * a.o_st +
               h * a.o_sh + col;
  *reinterpret_cast<__nv_bfloat162*>(orow) =
      __floats2bfloat162_rn(num.x * inv, num.y * inv);
  *reinterpret_cast<__nv_bfloat162*>(orow + 2) =
      __floats2bfloat162_rn(num.z * inv, num.w * inv);
  if (threadIdx.x == 0)
    a.lse[row] = den == 0.f ? kNegInf : mx + logf(den);
}

// Launches the kernel; returns the CUDA error of the launch, or 1000 plus
// the CUresult when a tensor map cannot be encoded.
template <bool VOWN>
int launch(const FwdParams& p, const Tiling& tl, int npt, int B,
           cudaStream_t s) {
  CUtensorMap mq, mk, mv;
  const int Hkv = p.Hq / p.group;
  int r = tile_map(&mq, p.q, DK, p.Hq, p.Tq, B, p.q_sh, p.q_st, p.q_sb,
                   tl.hg, tl.pg);
  if (r == 0)
    r = tile_map(&mk, p.k, DK, Hkv, p.Tk, B, p.k_sh, p.k_st, p.k_sb, 1,
                 keys<VOWN>());
  if (r == 0 && VOWN)
    r = tile_map(&mv, p.v, DV, Hkv, p.Tk, B, p.v_sh, p.v_st, p.v_sb, 1,
                 keys<VOWN>());
  if (r != 0) return 1000 + r;
  if (!VOWN) mv = mk;  // not read: v is k's staged prefix
  const size_t smem = latent_smem_bytes<VOWN>();
  static bool sized = false;  // the attribute is set once a process
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_latent_wgmma_kernel<VOWN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  flash_fwd_latent_wgmma_kernel<VOWN>
      <<<dim3(npt * tl.nhc * tl.nsplit, Hkv, B), kThreads, smem, s>>>(
          p, tl, mq, mk, mv);
  if (tl.nsplit > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_fwd_latent_merge_kernel<<<dim3(p.Tq * p.Hq, B), DV / 4, 0, s>>>(
        p, tl);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Kernel A's latent route, bf16 (ia's dtype must be 1): head dims (DK, DV)
// = (576, 512); ia as in flash_fwd_common.cuh with D = DK, then ia[29] = DV
// and ia[30] = 1 when v is a prefix view of k (same pointer and strides).
// nq and the bounds table are in position tiles of 64 / G positions (one
// position when G is a multiple of 64) over 64-key tiles, 32-key ones when
// v is a tensor of its own.  ia[31] = nsplit, the parts each tile's sweep
// is cut into; when it exceeds 1, o_part (nsplit, B, Tq, Hq, 512) and
// lse_part (nsplit, B, Tq, Hq), float32, hold the parts for the merge
// kernel.  Every row must start on 16 bytes.  Returns 0 when launched,
// else the CUDA error of the launch (cudaErrorInvalidValue for a group that
// neither divides 64 nor is a multiple of it), or 1000 plus the CUresult
// of a tensor map that could not be encoded.
extern "C" int repro_flash_fwd_latent_sm90(const void* q, const void* k,
                                           const void* v, void* o,
                                           void* lse, const void* bounds,
                                           const void* qseg,
                                           const void* kseg, void* o_part,
                                           void* lse_part,
                                           const long long* ia, float scale,
                                           void* stream) {
  Shape sh;
  const FwdParams p = repro_fwd::parse(q, k, v, o, lse, bounds, qseg, kseg,
                                       ia, scale, &sh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = p.group;
  if (sh.dtype != 1 || sh.D != DK || ia[29] != DV ||
      (kRows % G != 0 && G % kRows != 0) || ia[31] < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Tiling tl;
  tl.hg = G < kRows ? G : kRows;
  tl.pg = kRows / tl.hg;
  tl.nhc = G / tl.hg;
  tl.nsplit = static_cast<int>(ia[31]);
  tl.o_part = static_cast<float*>(o_part);
  tl.lse_part = static_cast<float*>(lse_part);
  return ia[30] ? launch<false>(p, tl, sh.nq, sh.B, s)
                : launch<true>(p, tl, sh.nq, sh.B, s);
}

// Dynamic shared memory of the kernel, in bytes: v k's prefix view
// (v_in_k = 1) or a tensor of its own (0).
extern "C" int repro_flash_fwd_latent_sm90_smem(int v_in_k) {
  return static_cast<int>(v_in_k ? latent_smem_bytes<false>()
                                 : latent_smem_bytes<true>());
}

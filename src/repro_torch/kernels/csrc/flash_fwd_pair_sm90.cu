// Kernel A, pair route, bf16: the FlashAttention-2 forward of one partial
// attention chunk on Hopper's tensor cores (sm_90a `wgmma`), written by
// hand, with a plain C entry point bound via ctypes, templated on the q/k
// and v head dims <DK, DV>.  Two instantiations:
//   <192, 128>: materialised multi-head latent attention (DeepSeek MLA's
//     whole-prompt prefill): per head, q/k are the nope 128 ⊕ rope 64
//     columns and v the 128 up-projected value columns, with one kv head a
//     query head (a GQA group of 1; any group works).  float32 inputs take
//     the CUDA-core route (flash_fwd_latent.cu at <192, 128>).
//   <160, 160>: the shared attention block of zamba2-2.7b (32 heads of 160
//     over concat(h, embed), 5120 wide).  The one-D bf16 route
//     (flash_fwd_sm90.cu) does not fit there: 160 columns are three 64-column
//     slabs, and its 128-key stages would need 344 KB of shared memory.
//     float32 inputs take flash_fwd.cu at <160>.
//
// Replaces the TPU kernel `_fwd_kernel` / `flash_fwd_bhtd` of the JAX
// package (src/repro/kernels/flash_attention.py:157, pallas_call at :252,
// where Dv may differ from Dk, :212-213) at those shapes.
//
// Bound on the H100: operations.  deepseek-v2-lite-16b's whole-prompt
// prefill of 2 prompts of 4096 tokens (16 heads, causal) does
// 2·(192 + 128) = 640 FLOPs for each of the 2.685e8 (row, key) pairs the
// mask allows (0.172 TFLOP) over 168 MB of q, k, v, o and lse: 0.174 ms at
// the bf16 tensor-core rate (989 TFLOP/s), against 0.050 ms for the bytes.
// zamba2's training step (T 8192, 32 heads of 160, causal: 1.074e9 pairs of
// 640 FLOPs) is bound at 0.695 ms.  What the design does about it: both
// products run on the tensor cores with float32 accumulators; every k and v
// tile is read once per 128 q rows and shared by two warpgroups; no score
// tile leaves the registers; the block-sparse table skips every kv tile the
// mask cannot reach.  p goes into the second product as two bf16 terms, so
// the design does 2·192 + 4·128 = 896 tensor FLOPs a pair at <192, 128>
// (1.4× the bound), and 2·160 + 4·192 = 1,088 at <160, 160> (1.7×: o += p·v
// runs as n192 over a zero third slab).
//
// Design.  One block per (128-row q tile, query head, batch row), heaviest
// q tiles first: two warpgroups (256 threads), warpgroup w owning q rows
// 64w .. 64w + 63.  This is the one-D bf16 route's design (flash_fwd_sm90.cu)
// at a kv tile of 64 keys instead of 128, which is what makes the wider q/k
// rows fit: a 128 × 192 q tile is 48 KiB, and a 128-key stage of k (48 KiB)
// and v (32 KiB) is 80 KiB, so three such stages would need 288 KiB of the
// 227 KiB a block may use.  A 64-key stage is 40 KiB: q and three stages
// take 168 KiB (at <160, 160>: 48 KiB stages of three slabs each, 193 KiB).
//   Loads.  Thread 0 requests both warpgroups' q slabs once by TMA (64-column
//   slabs of 64 rows each, in the 128-byte-swizzled layout `wgmma` reads;
//   rows past Tq and columns past DK arrive as zeros, so at 160 the third
//   slab's box holds 32 real columns and 32 zeros), and the q tile's 64-key
//   kv tiles [lo, hi] (the wrapper's host table,
//   kernels/block_sparse.kv_block_bounds at 128 × 64) through a ring of
//   three stages: k's slabs, then v's, each a TMA box of 64 rows ×
//   64 columns (rows past Tk zero-filled).  Each stage has a `full`
//   `mbarrier` (its bytes have landed) and an `empty` one (every thread
//   arrives once its products no longer read it).  Tile n + 2 is requested
//   while the s product of tile n runs, once both warpgroups have released
//   tile n − 1, so loads run two tiles ahead.
//   Products.  For each kv tile: s = q·kᵀ as DK / 16 k16 steps of `wgmma`
//   m64n64k16 (both operands in shared memory, K-major), the mask on edge
//   tiles only (outside the table's interior range, or past a ragged Tk),
//   the online softmax in float32 registers in the log2 domain, l summed
//   from float32 p, then o += p·v as `wgmma` m64n128k16 (DV 128) or
//   m64n192k16 (DV 160, the third slab's zero columns never written) with p
//   as the register A operand (the s accumulator's layout is the A fragment
//   layout, so p never leaves the registers) and v MN-major across its
//   slabs.
//   p goes in as two bf16 terms, hi = bf16(p) and lo = bf16(p − hi), into
//   one accumulator, for the element-wise bar (3e-2 of each output; a CPU
//   emulation of this arithmetic, tests/test_torch_kernels.py).
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

constexpr int kRows = 128;         // q rows a block: two warpgroups of 64
constexpr int kKeys = 64;          // keys a kv tile
constexpr int kStages = 3;         // kv tiles in the shared-memory ring
constexpr int kThreads = 256;      // two warpgroups

// The tile sizes at head dims <DK, DV> (q/k and v): 64-column slabs, the
// last one zero-padded when a head dim is not a multiple of 64.
template <int DK, int DV>
struct Dims {
  static constexpr int KSL = (DK + 63) / 64;  // slabs of a q or k tile
  static constexpr int VSL = (DV + 63) / 64;  // of a v tile
  static constexpr uint32_t kQBytes = KSL * 64 * 128;     // one warpgroup's q
  static constexpr uint32_t kKBytes = KSL * kKeys * 128;  // a k tile
  static constexpr uint32_t kVBytes = VSL * kKeys * 128;  // a v tile
  static constexpr uint32_t kStageBytes = kKBytes + kVBytes;
  static_assert(DK % 16 == 0 && (VSL == 2 || VSL == 3), "head dims");
};

// Two warpgroups' q slabs, kStages stages, 2·kStages + 1 mbarriers, and
// room to align the start to 1024 bytes.
template <int DK, int DV>
constexpr size_t pair_smem_bytes() {
  using T = Dims<DK, DV>;
  return 2 * T::kQBytes + kStages * T::kStageBytes + (2 * kStages + 1) * 8 +
         1024;
}

// ---------------------------------------------------------------- kernel

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_pair_wgmma_kernel(const FwdParams a,
                                const __grid_constant__ CUtensorMap tmq,
                                const __grid_constant__ CUtensorMap tmk,
                                const __grid_constant__ CUtensorMap tmv) {
  using T = Dims<DK, DV>;
  constexpr int KSL = T::KSL, VSL = T::VSL;
  constexpr uint32_t kQBytes = T::kQBytes, kKBytes = T::kKBytes;
  constexpr uint32_t kStageBytes = T::kStageBytes;
  constexpr int NS = kKeys / 2;   // score entries a thread: 64 × 64 / 128
  constexpr int KK = kKeys / 16;  // k16 steps of o += p·v
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t sQ = smem_u32(smem);       // warpgroup w's at sQ + w·kQBytes
  const uint32_t sKV = sQ + 2 * kQBytes;    // stage s at sKV + s·kStageBytes:
                                            // k, then v
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * kQBytes +
                                               kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  uint64_t* qfull = empty + kStages;

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
    mbar_init(qfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Kv tile n into stage n % kStages: k slab by slab, then v's (64 rows ×
  // 64 columns a box, rows past Tk zero-filled).
  auto load_kv = [&](int n) {
    const int s = n % kStages, k0 = (lo + n) * kKeys;
    const uint32_t kt = sKV + s * kStageBytes;
    mbar_expect_tx(full + s, kStageBytes);
#pragma unroll
    for (int c = 0; c < KSL; ++c)
      tma_load_4d(kt + c * (kKeys * 128), &tmk, 64 * c, hk, k0, b, full + s);
#pragma unroll
    for (int c = 0; c < VSL; ++c)
      tma_load_4d(kt + kKBytes + c * (kKeys * 128), &tmv, 64 * c, hk, k0, b,
                  full + s);
  };
  if (tid == 0) {
    mbar_expect_tx(qfull, 2 * kQBytes);
#pragma unroll
    for (int wq = 0; wq < 2; ++wq)
#pragma unroll
      for (int c = 0; c < KSL; ++c)
        tma_load_4d(sQ + wq * kQBytes + c * (64 * 128), &tmq, 64 * c, h,
                    q0 + 64 * wq, b, qfull);
    for (int n = 0; n < kStages - 1 && n < ntiles; ++n) load_kv(n);
  }

  const int w = tid >> 7, t128 = tid & 127;
  const int warp = t128 >> 5, lane = tid & 31;
  const uint32_t sQw = sQ + w * kQBytes;
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
  float acc[VSL][32];               // o's columns 64c + ...
#pragma unroll
  for (int c = 0; c < VSL; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;

  mbar_wait(qfull, 0);

  for (int n = 0; n < ntiles; ++n) {
    const int s = n % kStages;
    const int j = lo + n, k0 = j * kKeys;
    const uint32_t kt = sKV + s * kStageBytes, vt = kt + kKBytes;
    mbar_wait(full + s, (n / kStages) & 1);

    float sc[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = 0.f;
    fence_regs(sc);  // written before the fence, not sunk past it
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < DK / 16; ++ks)
      mma_ss(sc, kmajor<64>(sQw, ks), kmajor<kKeys>(kt, ks));
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
    const bool edge = (a.masked && (j < ilo || j > ihi)) || k0 + kKeys > a.Tk;
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
    for (int c = 0; c < VSL; ++c)
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
    // acc's rescaling and p's terms are pinned before the fence
#pragma unroll
    for (int c = 0; c < VSL; ++c) fence_regs(acc[c]);
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      fence_regs(ph[kk]);
      fence_regs(pl[kk]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const uint64_t dv = sw128_desc(vt + kk * 2048, kKeys * 128, 1024);
      if constexpr (VSL == 2) {
        mma_rs_n128(acc[0], acc[1], ph[kk], dv);
        mma_rs_n128(acc[0], acc[1], pl[kk], dv);
      } else {
        mma_rs_n192(acc[0], acc[1], acc[2], ph[kk], dv);
        mma_rs_n192(acc[0], acc[1], acc[2], pl[kk], dv);
      }
    }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int c = 0; c < VSL; ++c) fence_regs(acc[c]);
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      fence_regs(ph[kk]);
      fence_regs(pl[kk]);
    }
    mbar_arrive(empty + s);  // this thread no longer reads stage s
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
    for (int c = 0; c < VSL; ++c)
#pragma unroll
      for (int i = 2 * r; i < 32; i += 4)
        if (64 * c + 8 * (i >> 2) < DV)  // the zero slab's columns stay
          *reinterpret_cast<__nv_bfloat162*>(ob + t * a.o_st + 64 * c +
                                           8 * (i >> 2) + c0) =
            __floats2bfloat162_rn(acc[c][i] * inv, acc[c][i + 1] * inv);
    if ((lane & 3) == 0)
      a.lse[((long long)b * a.Tq + t) * a.Hq + h] =
          lt == 0.f ? kNegInf : m[r] * kLn2 + logf(lt);
  }
}

// Launches the kernel; returns the CUDA error of the launch, or 1000 plus
// the CUresult when a tensor map cannot be encoded.
template <int DK, int DV>
int launch(const FwdParams& p, int nq, int B, cudaStream_t s) {
  CUtensorMap mq, mk, mv;
  const int Hkv = p.Hq / p.group;
  int r = tile_map(&mq, p.q, DK, p.Hq, p.Tq, B, p.q_sh, p.q_st, p.q_sb, 1,
                   64);
  if (r == 0)
    r = tile_map(&mk, p.k, DK, Hkv, p.Tk, B, p.k_sh, p.k_st, p.k_sb, 1,
                 kKeys);
  if (r == 0)
    r = tile_map(&mv, p.v, DV, Hkv, p.Tk, B, p.v_sh, p.v_st, p.v_sb, 1,
                 kKeys);
  if (r != 0) return 1000 + r;
  const size_t smem = pair_smem_bytes<DK, DV>();
  static bool sized = false;  // the attribute is set once a process
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_pair_wgmma_kernel<DK, DV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  flash_fwd_pair_wgmma_kernel<DK, DV><<<dim3(p.Hq, nq, B), kThreads, smem, s>>>(
      p, mq, mk, mv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Kernel A's pair route, bf16 (ia's dtype must be 1): head dims (DK, DV) =
// (192, 128) or (160, 160); ia as in flash_fwd_common.cuh with D = DK, then
// ia[29] = DV (ia[30], whether v is a view into k, is not read: v has its
// own tensor map either way).  nq and the bounds table are in 128-row q
// tiles of 64-key kv tiles.  Every row must start on 16 bytes.  Returns 0
// when launched, else the CUDA error of the launch, or 1000 plus the
// CUresult of a tensor map that could not be encoded.
extern "C" int repro_flash_fwd_pair_sm90(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         const void* bounds,
                                         const void* qseg, const void* kseg,
                                         const long long* ia, float scale,
                                         void* stream) {
  Shape sh;
  const FwdParams p = repro_fwd::parse(q, k, v, o, lse, bounds, qseg, kseg,
                                       ia, scale, &sh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sh.dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (sh.D == 192 && ia[29] == 128) return launch<192, 128>(p, sh.nq, sh.B, s);
  if (sh.D == 160 && ia[29] == 160) return launch<160, 160>(p, sh.nq, sh.B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of the kernel at head dims (dk, dv), in bytes; 0
// for a pair it does not take.
extern "C" int repro_flash_fwd_pair_sm90_smem(int dk, int dv) {
  if (dk == 192 && dv == 128) return static_cast<int>(pair_smem_bytes<192, 128>());
  if (dk == 160 && dv == 160) return static_cast<int>(pair_smem_bytes<160, 160>());
  return 0;
}

// What kernels C and D share across their two routes (flash_bwd.cu, the
// float32 CUDA-core route, and flash_bwd_sm90.cu, the bf16 tensor-core
// route): the launch parameters, the host-side parsing of the wrapper's
// int64 argument array, and the MaskSpec of one (query, key) pair.
#pragma once

#include <cuda_runtime.h>

namespace repro_bwd {

constexpr float kNegInf = -1e30f;

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

// The MaskSpec of one (query, key) position pair (core/mask.py).
__device__ __forceinline__ bool allowed(const BwdParams& a, int qp, int kp,
                                        int qs, int ks) {
  const bool pre = a.prefix_len > 0 && kp < a.prefix_len;
  bool ok = true;
  if (a.causal) ok = kp <= qp || pre;
  if (ok && a.window > 0) ok = qp - kp < a.window || pre;
  if (ok && a.has_seg) ok = qs == ks || pre;
  return ok;
}

// D is the head dim of q and k (and dq, dk), Dv that of v and o (and do,
// dv); one-D calls have Dv = D.
struct Shape {
  int B, Hkv, D, Dv, dtype, nq, nk;
};

// ia (int64): B, Tq, Tk, Hq, Hkv, D, dtype (0 f32, 1 bf16), nq, nk,
//   strides (b, t, h) of q, k, v, o, do, dq, dk, dv,
//   causal, window, prefix_len, q_offset, kv_offset, has_seg,
//   q-segment batch stride, kv-segment batch stride, masked, compute_delta,
//   Dv.
inline Shape parse(const long long* ia, BwdParams* p) {
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
  sh.Dv = static_cast<int>(ia[43]);
  return sh;
}

// The parameters of one call of kernel C (dq_args) or kernel D (dkv_args)
// from the C entry points' pointers.
inline BwdParams dq_args(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const void* lse,
                         void* delta, void* dq, const void* bounds,
                         const void* qseg, const void* kseg,
                         const long long* ia, float scale, Shape* sh) {
  BwdParams p = {};
  *sh = parse(ia, &p);
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
  return p;
}

inline BwdParams dkv_args(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv,
                          const void* bounds, const void* qbounds,
                          const void* qseg, const void* kseg,
                          const long long* ia, float scale, Shape* sh) {
  BwdParams p = {};
  *sh = parse(ia, &p);
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
  return p;
}

}  // namespace repro_bwd

// What kernel A shares across its two routes (flash_fwd.cu, the float32
// CUDA-core route, and flash_fwd_sm90.cu, the bf16 tensor-core route): the
// launch parameters, the host-side parsing of the wrapper's int64 argument
// array, and the MaskSpec of one (query, key) pair.
#pragma once

#include <cuda_runtime.h>

namespace repro_fwd {

constexpr float kNegInf = -1e30f;

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;         // (B, Tq, Hq)
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

// The MaskSpec of one (query, key) position pair (core/mask.py).
__device__ __forceinline__ bool allowed(const FwdParams& a, int qp, int kp,
                                        int qs, int ks) {
  const bool pre = a.prefix_len > 0 && kp < a.prefix_len;
  bool ok = true;
  if (a.causal) ok = kp <= qp || pre;
  if (ok && a.window > 0) ok = qp - kp < a.window || pre;
  if (ok && a.has_seg) ok = qs == ks || pre;
  return ok;
}

struct Shape {
  int B, D, dtype, nq;
};

// ia (int64): B, Tq, Tk, Hq, Hkv, D, dtype (0 f32, 1 bf16), nq,
//   q strides (b, t, h), k strides, v strides, o strides,
//   causal, window, prefix_len, q_offset, kv_offset, has_seg,
//   q-segment batch stride, kv-segment batch stride, masked.
inline FwdParams parse(const void* q, const void* k, const void* v, void* o,
                       void* lse, const void* bounds, const void* qseg,
                       const void* kseg, const long long* ia, float scale,
                       Shape* sh) {
  FwdParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.bounds = static_cast<const int*>(bounds);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  sh->B = static_cast<int>(ia[0]);
  p.Tq = static_cast<int>(ia[1]);
  p.Tk = static_cast<int>(ia[2]);
  p.Hq = static_cast<int>(ia[3]);
  p.group = static_cast<int>(ia[3] / ia[4]);
  sh->D = static_cast<int>(ia[5]);
  sh->dtype = static_cast<int>(ia[6]);
  sh->nq = static_cast<int>(ia[7]);
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
  return p;
}

}  // namespace repro_fwd

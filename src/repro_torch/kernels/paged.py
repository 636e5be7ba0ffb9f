"""Kernel B — paged flash-decode attention through a block table (the port
of the reference's ``_paged_kernel`` / ``paged_attn_pallas``,
``kernels/paged.py``).

Layout (the reference's):

  q            (B, Tq, Hq, D)     row ``t`` of request ``b`` sits at context
                                  position ``lengths[b] − Tq + t``
  k_pool       (N, bs, Hkv, D)    one layer's key pool (N = pool blocks)
  v_pool       (N, bs, Hkv, D)
  block_table  (B, nb) int32      request b's i-th block id (0 = the reserved
                                  null block)
  lengths      (B,) int32         attendable tokens incl. the new ones

The mask is ``causal`` or ``sliding_window``, evaluated per row against
``lengths``.  :func:`paged_attn_ref` is the plain PyTorch version (gather
the whole table, materialise the scores); :func:`paged_attn` runs it for
CPU tensors and launches the hand-written kernel (``csrc/paged_decode.cu``)
for CUDA tensors, or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.mask import MaskSpec, causal
from repro_torch.kernels import build
from repro_torch.kernels.ref import NEG_INF

HEAD_DIMS = (32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_SIZES = (8, 64)           # inclusive range the kernel takes

_FN = []


def _fn():
    if not _FN:
        f = build.load("paged_decode").repro_paged_decode
        f.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
            ctypes.c_void_p]
        f.restype = ctypes.c_int
        _FN.append(f)
    return _FN[0]


def _check(q, k_pool, v_pool, block_table, lengths, mask: MaskSpec):
    if q.shape[1] < 1:
        raise ValueError(f"paged decode takes >= 1 query tokens, got "
                         f"Tq={q.shape[1]}")
    if mask.kinds - {"causal", "sliding_window"}:
        raise ValueError(f"paged decode serves causal/sliding_window masks "
                         f"only (got {mask.kind!r})")
    if mask.q_offset or mask.kv_offset:
        raise ValueError("paged decode mask must be offset-free — positions "
                         "come from `lengths`")
    if k_pool.shape[:3] != v_pool.shape[:3]:
        raise ValueError(f"k_pool/v_pool disagree: {tuple(k_pool.shape)} vs "
                         f"{tuple(v_pool.shape)}")
    if q.shape[2] % k_pool.shape[2]:
        raise ValueError(f"Hq={q.shape[2]} not a multiple of "
                         f"Hkv={k_pool.shape[2]}")


def _allow_tokens(mask: MaskSpec, kpos, lengths, Tq: int):
    """(B, Tq, T) attendability of virtual context position ``kpos`` (T,)."""
    qpos = (lengths[:, None] - Tq
            + torch.arange(Tq, device=lengths.device)[None, :])  # (B, Tq)
    ok = kpos[None, None, :] <= qpos[:, :, None]
    if mask.window:
        ok = ok & (kpos[None, None, :] > qpos[:, :, None] - mask.window)
    return ok


def paged_attn_ref(q, k_pool, v_pool, block_table, lengths, *,
                   mask: MaskSpec | None = None, scale=None):
    """Plain version: gather the whole table, materialise the scores.
    Returns o (B, Tq, Hq, Dv)."""
    mask = causal() if mask is None else mask
    _check(q, k_pool, v_pool, block_table, lengths, mask)
    B, Tq, Hq, Dq = q.shape
    nb = block_table.shape[1]
    bs, Hkv = k_pool.shape[1], k_pool.shape[2]
    g = Hq // Hkv
    sc = scale if scale is not None else 1.0 / (Dq ** 0.5)
    bt = block_table.long()
    kg = k_pool[bt].reshape(B, nb * bs, Hkv, -1).float()
    vg = v_pool[bt].reshape(B, nb * bs, Hkv, -1).float()
    if g > 1:
        kg = kg.repeat_interleave(g, dim=2)
        vg = vg.repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kg) * sc
    ok = _allow_tokens(mask, torch.arange(nb * bs, device=q.device),
                       lengths.to(q.device).long(), Tq)
    s = torch.where(ok[:, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    m_safe = torch.clamp(m, min=NEG_INF / 2)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(m[..., None] <= NEG_INF / 2, torch.zeros_like(p), p)
    den = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vg)
    den_t = den.transpose(1, 2)[..., None]
    o = o / torch.where(den_t == 0.0, torch.ones_like(den_t), den_t)
    o = torch.where(den_t == 0.0, torch.zeros_like(o), o)
    return o.to(q.dtype)


def _check_cuda(q, k_pool, v_pool, block_table, lengths, mask):
    dev = q.device
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_table", block_table), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if q.dtype not in DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise ValueError(f"paged decode kernel takes one of {list(DTYPES)} "
                         f"for q and pools, got {q.dtype}/{k_pool.dtype}/"
                         f"{v_pool.dtype}")
    D = q.shape[-1]
    if D not in HEAD_DIMS or k_pool.shape[-1] != D or v_pool.shape[-1] != D:
        raise ValueError(f"paged decode kernel takes head dims {HEAD_DIMS}, "
                         f"got {D}/{k_pool.shape[-1]}/{v_pool.shape[-1]}")
    bs = k_pool.shape[1]
    if not BLOCK_SIZES[0] <= bs <= BLOCK_SIZES[1]:
        raise ValueError(f"paged decode kernel takes block sizes "
                         f"{BLOCK_SIZES[0]}..{BLOCK_SIZES[1]}, got {bs}")
    # each lane loads D/32 consecutive elements as one vector
    vec = D // 32
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.ndim != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be 4-d with a unit-stride last "
                             f"dim, got strides {t.stride()}")
        if any(st % vec for st in t.stride()[:3]) \
                or t.data_ptr() % (vec * t.element_size()):
            raise ValueError(f"{name} rows must be aligned to {vec} "
                             f"elements for the kernel's vector loads")
    if block_table.dtype != torch.int32 or block_table.ndim != 2 \
            or block_table.stride(1) != 1 \
            or block_table.shape[0] != q.shape[0]:
        raise ValueError("block_table must be (B, nb) int32 with unit "
                         "column stride")
    if lengths.dtype != torch.int32 or lengths.shape != (q.shape[0],) \
            or not lengths.is_contiguous():
        raise ValueError("lengths must be a contiguous (B,) int32 tensor")


def paged_attn(q, k_pool, v_pool, block_table, lengths, *,
               mask: MaskSpec | None = None, scale=None):
    """Paged decode attention: plain version on the CPU, kernel B on CUDA."""
    mask = causal() if mask is None else mask
    if q.device.type == "cpu":
        return paged_attn_ref(q, k_pool, v_pool, block_table, lengths,
                              mask=mask, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attn runs on cpu or cuda, got {q.device}")
    _check(q, k_pool, v_pool, block_table, lengths, mask)
    _check_cuda(q, k_pool, v_pool, block_table, lengths, mask)
    B, Tq, Hq, D = q.shape
    bs, Hkv = k_pool.shape[1], k_pool.shape[2]
    sc = scale if scale is not None else 1.0 / (D ** 0.5)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    ia = build.int64_args(
        B, Tq, Hq, Hkv, D, DTYPES[q.dtype], bs, block_table.shape[1],
        mask.window, *q.stride()[:3], *k_pool.stride()[:3],
        *v_pool.stride()[:3], *o.stride()[:3], block_table.stride(0))
    err = _fn()(build.ptr(q), build.ptr(k_pool), build.ptr(v_pool),
                 build.ptr(o), build.ptr(block_table), build.ptr(lengths),
                 ia, float(sc), build.stream_ptr(q.device))
    if err:
        raise RuntimeError(f"paged_decode kernel launch failed (CUDA error "
                           f"{err})")
    build.LAUNCHES["paged_decode"] += 1
    return o

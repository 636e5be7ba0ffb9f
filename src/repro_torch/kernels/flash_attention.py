"""Kernel A — FlashAttention-2 forward of one partial chunk (the port of the
reference's ``_fwd_kernel`` / ``flash_fwd_bhtd`` in
``kernels/flash_attention.py``).

:func:`flash_fwd` takes the model's (B, T, H, D) layout and a static
:class:`~repro_torch.core.mask.MaskSpec`, and returns ``(o (B,Tq,Hq,D),
lse (B,Tq,Hq) float32)``.  On a CPU tensor it runs the plain PyTorch version
(:func:`~repro_torch.kernels.ref.chunk_attn_ref`); on a CUDA tensor it
launches the hand-written kernel (``csrc/flash_fwd.cu``) or raises — there
is no fallback.

The block-sparse sweep is planned on the host: for each 64-row q tile the
wrapper computes the reachable 64-key tile range ``[lo, hi]`` and the
interior range where the mask cannot bite (``block_sparse.kv_block_bounds``
/ ``interior_kv_bounds``), and ships them as one small int32 table.  A chunk
that is statically fully masked returns zeros and NEG_INF without a launch.
``prune=False`` sweeps every tile and masks every tile (the reference's
dense baseline).  Static document ``boundaries`` become segment-ID arrays.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.mask import MaskSpec, full
from repro_torch.kernels import build
from repro_torch.kernels.block_sparse import (interior_kv_bounds,
                                              kv_block_bounds)
from repro_torch.kernels.ref import NEG_INF, chunk_attn_ref

BLOCK_Q = 64
BLOCK_KV = 64
HEAD_DIMS = (32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_FN = []


def _fn():
    if not _FN:
        f = build.load("flash_fwd").repro_flash_fwd
        f.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
            ctypes.c_void_p]
        f.restype = ctypes.c_int
        _FN.append(f)
    return _FN[0]


def tile_bounds(mask: MaskSpec, Tq: int, Tk: int, prune: bool = True):
    """Per q tile ``(lo, hi, interior_lo, interior_hi)`` of 64-key tiles, as
    a list of tuples (host-side sweep plan of kernel A)."""
    nq, nk = -(-Tq // BLOCK_Q), -(-Tk // BLOCK_KV)
    rows = []
    for i in range(nq):
        if not prune:
            rows.append((0, nk - 1, 1, 0))
            continue
        lo, hi = (kv_block_bounds(i, br=BLOCK_Q, bc=BLOCK_KV, nk=nk,
                                  mask=mask)
                  if mask.prunable else (0, nk - 1))
        ilo, ihi = interior_kv_bounds(i, br=BLOCK_Q, bc=BLOCK_KV, nk=nk,
                                      mask=mask)
        rows.append((lo, hi, ilo, ihi))
    return rows


@functools.lru_cache(maxsize=256)
def _device_bounds(mask: MaskSpec, Tq: int, Tk: int, prune: bool,
                   device: str):
    rows = tile_bounds(mask, Tq, Tk, prune)
    empty = all(hi < lo for lo, hi, _, _ in rows)
    t = torch.tensor(rows, dtype=torch.int32).to(device)
    return t, empty


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if t.ndim != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be (B, T, H, D) with a unit-stride "
                             f"last dim, got {tuple(t.shape)} strides "
                             f"{t.stride()}")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_fwd kernel takes {list(DTYPES)}, got "
                         f"{q.dtype}")
    B, Tq, Hq, D = q.shape
    if D not in HEAD_DIMS or k.shape[-1] != D or v.shape[-1] != D:
        raise ValueError(f"flash_fwd kernel takes head dims {HEAD_DIMS} "
                         f"(equal for q, k, v), got {D}/{k.shape[-1]}/"
                         f"{v.shape[-1]}")
    if k.shape[:3] != v.shape[:3] or k.shape[0] != B:
        raise ValueError(f"k/v shapes {tuple(k.shape)} {tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if Hq % k.shape[2]:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={k.shape[2]}")


def _segments(mask: MaskSpec, segs, T: int, offset: int, device):
    """(segment tensor, batch stride): the caller's (B, T) ids, or the static
    boundaries' ids broadcast over the batch (stride 0)."""
    if segs is not None:
        s = segs.to(device=device, dtype=torch.int32).contiguous()
        return s, s.stride(0)
    pos = offset + torch.arange(T, device=device)
    return mask.segment_of(pos).contiguous(), 0


def _flash_fwd_cuda(q, k, v, mask, scale, q_segments, kv_segments, prune):
    _check(q, k, v)
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    bounds, empty = _device_bounds(mask, Tq, Tk, bool(prune), str(q.device))
    if empty:                            # statically fully masked chunk
        return (torch.zeros(q.shape, dtype=q.dtype, device=q.device),
                torch.full((B, Tq, Hq), NEG_INF, dtype=torch.float32,
                           device=q.device))
    qs = ks = None
    qs_sb = ks_sb = 0
    if mask.document:
        qs, qs_sb = _segments(mask, q_segments, Tq, mask.q_offset, q.device)
        ks, ks_sb = _segments(mask, kv_segments, Tk, mask.kv_offset, q.device)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Tq, Hq), dtype=torch.float32, device=q.device)
    ia = build.int64_args(
        B, Tq, Tk, Hq, Hkv, D, DTYPES[q.dtype], bounds.shape[0],
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        mask.causal, mask.window, mask.prefix_len, mask.q_offset,
        mask.kv_offset, mask.document, qs_sb, ks_sb, mask.needs_mask)
    err = _fn()(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(o),
                build.ptr(lse), build.ptr(bounds), build.ptr(qs),
                build.ptr(ks), ia, float(scale), build.stream_ptr(q.device))
    if err:
        raise RuntimeError(f"flash_fwd kernel launch failed (CUDA error "
                           f"{err})")
    build.LAUNCHES["flash_fwd"] += 1
    return o, lse


def flash_fwd(q, k, v, *, mask: MaskSpec | None = None,
              scale: float | None = None, q_segments=None, kv_segments=None,
              prune: bool = True):
    """(B,T,H,D) partial attention -> (o (B,Tq,Hq,D), lse (B,Tq,Hq) f32)."""
    mask = full() if mask is None else mask
    if (q_segments is None) != (kv_segments is None):
        raise ValueError("q_segments and kv_segments must be passed together")
    if mask.needs_segments and q_segments is None:
        raise ValueError("document mask without boundaries needs "
                         "q_segments/kv_segments")
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return chunk_attn_ref(q, k, v, mask=mask, scale=scale,
                              q_segments=q_segments, kv_segments=kv_segments)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cpu or cuda, got {q.device}")
    return _flash_fwd_cuda(q, k, v, mask, scale, q_segments, kv_segments,
                           prune)

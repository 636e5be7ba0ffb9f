"""Kernels A, C and D — FlashAttention-2 forward and backward of one partial
chunk (the port of the reference's ``_fwd_kernel``, ``_dq_kernel`` and
``_dkv_kernel`` / ``flash_fwd_bhtd``, ``flash_bwd_bhtd`` in
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

:func:`flash_bwd` is the backward from the saved ``(o, lse)``: kernel C
(``csrc/flash_bwd.cu``) sweeps each q tile over the forward's table and
writes dq (and ``delta = rowsum(o ⊙ do)``, unless the caller passes it);
kernel D sweeps each kv tile over the transposed table
(``block_sparse.q_block_bounds``) and every query head of its GQA group,
and writes dk and dv.  On a CPU tensor it runs
:func:`~repro_torch.kernels.ref.chunk_attn_bwd_ref`.  :class:`FlashAttnFn`
makes the pair differentiable.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.mask import MaskSpec, full
from repro_torch.kernels import build
from repro_torch.kernels.block_sparse import (interior_kv_bounds,
                                              kv_block_bounds,
                                              q_block_bounds)
from repro_torch.kernels.ref import NEG_INF, chunk_attn_bwd_ref, chunk_attn_ref

BLOCK_Q = 64
BLOCK_KV = 64
HEAD_DIMS = (32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_FNS = {}


def _entry(lib: str, name: str, n_ptrs: int):
    """The C entry point ``name`` of kernel library ``lib``: ``n_ptrs``
    pointers, then the int64 argument array, the scale and the stream."""
    if name not in _FNS:
        f = getattr(build.load(lib), name)
        f.argtypes = [ctypes.c_void_p] * n_ptrs + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
            ctypes.c_void_p]
        f.restype = ctypes.c_int
        _FNS[name] = f
    return _FNS[name]


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


def q_tile_bounds(mask: MaskSpec, Tq: int, Tk: int, prune: bool = True):
    """Per kv tile ``(lo, hi)`` of 64-row q tiles: the transposed sweep plan
    of kernel D."""
    nq, nk = -(-Tq // BLOCK_Q), -(-Tk // BLOCK_KV)
    if not (prune and mask.prunable):
        return [(0, nq - 1)] * nk
    return [q_block_bounds(j, br=BLOCK_Q, bc=BLOCK_KV, nq=nq, mask=mask)
            for j in range(nk)]


@functools.lru_cache(maxsize=256)
def _device_bounds(mask: MaskSpec, Tq: int, Tk: int, prune: bool,
                   device: str):
    rows = tile_bounds(mask, Tq, Tk, prune)
    empty = all(hi < lo for lo, hi, _, _ in rows)
    t = torch.tensor(rows, dtype=torch.int32).to(device)
    return t, empty


@functools.lru_cache(maxsize=256)
def _device_q_bounds(mask: MaskSpec, Tq: int, Tk: int, prune: bool,
                     device: str):
    rows = q_tile_bounds(mask, Tq, Tk, prune)
    return torch.tensor(rows, dtype=torch.int32).to(device)


def _check(q, k, v, **more):
    for name, t in (("q", q), ("k", k), ("v", v), *more.items()):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if t.ndim != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be (B, T, H, D) with a unit-stride "
                             f"last dim, got {tuple(t.shape)} strides "
                             f"{t.stride()}")
    if q.dtype not in DTYPES:
        raise ValueError(f"each flash kernel takes {list(DTYPES)}, got "
                         f"{q.dtype}")
    B, Tq, Hq, D = q.shape
    if D not in HEAD_DIMS or k.shape[-1] != D or v.shape[-1] != D:
        raise ValueError(f"each flash kernel takes head dims {HEAD_DIMS} "
                         f"(equal for q, k, v), got {D}/{k.shape[-1]}/"
                         f"{v.shape[-1]}")
    if k.shape[:3] != v.shape[:3] or k.shape[0] != B:
        raise ValueError(f"k/v shapes {tuple(k.shape)} {tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if Hq % k.shape[2]:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={k.shape[2]}")
    for name, t in more.items():
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q shape "
                             f"{tuple(q.shape)}")


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
    err = _entry("flash_fwd", "repro_flash_fwd", 8)(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(o),
        build.ptr(lse), build.ptr(bounds), build.ptr(qs), build.ptr(ks), ia,
        float(scale), build.stream_ptr(q.device))
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


# ------------------------------------------------------------- backward

def _bwd_args(q, k, v, o, do, dq, dk, dv, mask, qs_sb, ks_sb, nq, nk,
              compute_delta):
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    strides = []
    for t in (q, k, v, o, do, dq, dk, dv):
        strides += list(t.stride()[:3]) if t is not None else [0, 0, 0]
    return build.int64_args(
        B, Tq, Tk, Hq, Hkv, D, DTYPES[q.dtype], nq, nk, *strides,
        mask.causal, mask.window, mask.prefix_len, mask.q_offset,
        mask.kv_offset, mask.document, qs_sb, ks_sb, mask.needs_mask,
        compute_delta)


class _BwdPlan:
    """Inputs of kernels C and D for one backward call: the host tables,
    segment ids, and float32 lse / delta in (B, Tq, Hq) layout."""

    def __init__(self, q, k, v, o, lse, do, mask, delta, q_segments,
                 kv_segments, prune):
        _check(q, k, v, o=o, do=do)
        B, Tq, Hq, _ = q.shape
        Tk = k.shape[1]
        dev = q.device
        self.bounds, self.empty = _device_bounds(mask, Tq, Tk, bool(prune),
                                                 str(dev))
        self.q_bounds = _device_q_bounds(mask, Tq, Tk, bool(prune), str(dev))
        self.nq, self.nk = self.bounds.shape[0], self.q_bounds.shape[0]
        self.qs = self.ks = None
        self.qs_sb = self.ks_sb = 0
        if mask.document:
            self.qs, self.qs_sb = _segments(mask, q_segments, Tq,
                                            mask.q_offset, dev)
            self.ks, self.ks_sb = _segments(mask, kv_segments, Tk,
                                            mask.kv_offset, dev)
        if lse.shape != (B, Tq, Hq):
            raise ValueError(f"lse shape {tuple(lse.shape)} != "
                             f"{(B, Tq, Hq)}")
        self.lse = lse.to(device=dev, dtype=torch.float32).contiguous()
        self.compute_delta = delta is None
        self.delta = (torch.empty((B, Tq, Hq), dtype=torch.float32,
                                  device=dev) if delta is None else
                      delta.to(device=dev, dtype=torch.float32).contiguous())
        self.q, self.k, self.v, self.o, self.do = q, k, v, o, do
        self.mask = mask


def _launch_dq(pl: _BwdPlan, scale):
    """Kernel C: dq (and delta, unless it was passed in)."""
    q = pl.q
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    ia = _bwd_args(q, pl.k, pl.v, pl.o, pl.do, dq, None, None, pl.mask,
                   pl.qs_sb, pl.ks_sb, pl.nq, pl.nk, pl.compute_delta)
    err = _entry("flash_bwd", "repro_flash_bwd_dq", 11)(
        build.ptr(q), build.ptr(pl.k), build.ptr(pl.v), build.ptr(pl.o),
        build.ptr(pl.do), build.ptr(pl.lse), build.ptr(pl.delta),
        build.ptr(dq), build.ptr(pl.bounds), build.ptr(pl.qs),
        build.ptr(pl.ks), ia, float(scale), build.stream_ptr(q.device))
    if err:
        raise RuntimeError(f"flash_bwd dq kernel launch failed (CUDA error "
                           f"{err})")
    build.LAUNCHES["flash_bwd_dq"] += 1
    return dq


def _launch_dkv(pl: _BwdPlan, scale):
    """Kernel D: dk and dv, summed over each GQA group on chip."""
    k, v = pl.k, pl.v
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    ia = _bwd_args(pl.q, k, v, None, pl.do, None, dk, dv, pl.mask, pl.qs_sb,
                   pl.ks_sb, pl.nq, pl.nk, 0)
    err = _entry("flash_bwd", "repro_flash_bwd_dkv", 12)(
        build.ptr(pl.q), build.ptr(k), build.ptr(v), build.ptr(pl.do),
        build.ptr(pl.lse), build.ptr(pl.delta), build.ptr(dk),
        build.ptr(dv), build.ptr(pl.bounds), build.ptr(pl.q_bounds),
        build.ptr(pl.qs), build.ptr(pl.ks), ia, float(scale),
        build.stream_ptr(k.device))
    if err:
        raise RuntimeError(f"flash_bwd dkv kernel launch failed (CUDA error "
                           f"{err})")
    build.LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def flash_bwd(q, k, v, o, lse, do, *, mask: MaskSpec | None = None,
              scale: float | None = None, delta=None, q_segments=None,
              kv_segments=None, prune: bool = True):
    """Backward of :func:`flash_fwd` from its saved ``(o, lse)``, in the
    (B, T, H, D) layout: returns (dq, dk, dv) in the dtypes of q, k, v,
    with dk/dv summed over each GQA group.  ``delta = rowsum(o ⊙ do)``
    (B, Tq, Hq) may be passed precomputed."""
    mask = full() if mask is None else mask
    if (q_segments is None) != (kv_segments is None):
        raise ValueError("q_segments and kv_segments must be passed together")
    if mask.needs_segments and q_segments is None:
        raise ValueError("document mask without boundaries needs "
                         "q_segments/kv_segments")
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return chunk_attn_bwd_ref(q, k, v, o, lse, do, mask=mask,
                                  scale=scale, delta=delta,
                                  q_segments=q_segments,
                                  kv_segments=kv_segments)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd runs on cpu or cuda, got {q.device}")
    pl = _BwdPlan(q, k, v, o, lse, do, mask, delta, q_segments, kv_segments,
                  prune)
    if pl.empty:                         # statically fully masked chunk
        return (torch.zeros(q.shape, dtype=q.dtype, device=q.device),
                torch.zeros(k.shape, dtype=k.dtype, device=k.device),
                torch.zeros(v.shape, dtype=v.dtype, device=v.device))
    dq = _launch_dq(pl, scale)
    dk, dv = _launch_dkv(pl, scale)
    return dq, dk, dv


class FlashAttnFn(torch.autograd.Function):
    """Differentiable partial attention ``(o, lse) = fwd(q, k, v)`` whose
    backward is ``bwd(q, k, v, o, lse, do) -> (dq, dk, dv)`` from the saved
    ``(q, k, v, o, lse)`` — no forward recompute.  ``fwd`` / ``bwd`` are
    :func:`flash_fwd` / :func:`flash_bwd` with the call's mask and options
    bound (``core.dist_attention.dist_flash_attn`` passes its own pair).
    ``lse`` is a residual output: its gradient is ignored, as in the
    reference's ``dist_flash_attn``.

        o, lse = FlashAttnFn.apply(q, k, v, fwd, bwd)
    """

    @staticmethod
    def forward(ctx, q, k, v, fwd, bwd):
        o, lse = fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.bwd = bwd
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ctx.bwd(q, k, v, o, lse, do)
        return dq, dk, dv, None, None

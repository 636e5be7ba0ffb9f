"""Kernels A, C and D — FlashAttention-2 forward and backward of one partial
chunk (the port of the reference's ``_fwd_kernel``, ``_dq_kernel`` and
``_dkv_kernel`` / ``flash_fwd_bhtd``, ``flash_bwd_bhtd`` in
``kernels/flash_attention.py``).

:func:`flash_fwd` takes the model's (B, T, H, D) layout and a static
:class:`~repro_torch.core.mask.MaskSpec`, and returns ``(o (B,Tq,Hq,Dv),
lse (B,Tq,Hq) float32)``.  On a CPU tensor it runs the plain PyTorch version
(:func:`~repro_torch.kernels.ref.chunk_attn_ref`); on a CUDA tensor it
launches a hand-written kernel or raises — there is no fallback.  One head
dim D of ``HEAD_DIMS`` for q, k and v takes one of two routes, chosen by
dtype (``FWD_ROUTES``): bf16 inputs (the serving and training paths') run
on the tensor cores (``csrc/flash_fwd_sm90.cu``, ``wgmma``, 128-row q tiles
over 128-key kv tiles), float32 inputs on the CUDA cores
(``csrc/flash_fwd.cu``, 64 × 64 tiles, IEEE float32 products for the
float32 bar).  The head-dim pairs of ``LATENT_DIMS`` (q/k 576, v 512:
absorbed MLA, v a prefix view of k) take the latent route, again chosen by
dtype (``LATENT_ROUTES``): bf16 on the tensor cores
(``csrc/flash_fwd_latent_sm90.cu``, ``wgmma`` over 64-row tiles of
(position, head) pairs of one kv head's group that share one staged
latent tile, 64-key tiles, each tile's sweep cut into parts merged by a
second kernel when the tiles alone leave half the SMs idle; the group must
divide 64 or be a multiple of it), float32 on the CUDA cores
(``csrc/flash_fwd_latent.cu``, 16 × 32 tiles).  The pairs of
``PAIR_DIMS`` (q/k 192, v 128: materialised MLA, per-head k and v, one kv
head a query head) take the pair route (``PAIR_ROUTES``): bf16 on the
tensor cores (``csrc/flash_fwd_pair_sm90.cu``, the one-D bf16 route's
design — 128-row q tiles on two warpgroups, ``wgmma`` — over 64-key tiles),
float32 on the CUDA cores (``csrc/flash_fwd_latent.cu`` at <192, 128>).
Any other pair raises.  Head dim 160 (zamba2's shared attention block) is
one D of ``HEAD_DIMS`` whose bf16 inputs take the pair route's library at
<160, 160> (``WIDE_DIMS``: the one-D bf16 route's 128-key stages do not fit
three 64-column slabs), and float32 inputs ``csrc/flash_fwd.cu`` at <160>;
its launches count as ``flash_fwd_160``.

The block-sparse sweep is planned on the host: for each q tile the wrapper
computes the reachable kv tile range ``[lo, hi]`` and the interior range
where the mask cannot bite (``block_sparse.kv_block_bounds`` /
``interior_kv_bounds``) at the route's tile sizes, and ships them as one
small int32 table.  A chunk that is statically fully masked returns zeros
and NEG_INF without a launch.
``prune=False`` sweeps every tile and masks every tile (the reference's
dense baseline).  Static document ``boundaries`` become segment-ID arrays.

:func:`flash_bwd` is the backward from the saved ``(o, lse)``: kernel C
sweeps each q tile over the forward's table and writes dq (and
``delta = rowsum(o ⊙ do)``, unless the caller passes it); kernel D sweeps
each kv tile over the transposed table (``block_sparse.q_block_bounds``)
and every query head of its GQA group, and writes dk and dv.  Two routes:
bf16 inputs (the training path's) run on the tensor cores
(``csrc/flash_bwd_sm90.cu``, ``wgmma``), float32 inputs on the CUDA cores
(``csrc/flash_bwd.cu``, IEEE float32 products for the float32 bar).  The
pair of ``PAIR_DIMS`` (q/k 192, v 128: materialised MLA, which the MoE
model trains through) takes ``PAIR_BWD_ROUTES``: bf16 on the tensor cores
(``csrc/flash_bwd_pair_sm90.cu``: a TMA producer warp and two consumer
warpgroups that hand p across, D in one pass), float32 the CUDA-core
library's <192, 128>; v may be a strided view, dk and dv are fresh
contiguous tensors.  Head dim 160 takes the same routes at <160, 160>
(counted as ``flash_bwd_dq_160`` / ``flash_bwd_dkv_160``).  The latent
pair stays forward-only (absorbed MLA is never trained), and any other
pair raises.  On a CPU tensor it runs :func:`~repro_torch.kernels.ref.chunk_attn_bwd_ref`.
:class:`FlashAttnFn` makes the pair differentiable.
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
HEAD_DIMS = (32, 64, 128, 160)
# one head dims whose bf16 route is the pair library's (kernels A, C and D
# at <D, D>), each counted under its own name (``flash_fwd_160``, ...)
WIDE_DIMS = (160,)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# kernel A: (library, entry point, q rows and keys per tile) by dtype
FWD_ROUTES = {torch.float32: ("flash_fwd", "repro_flash_fwd", 64),
              torch.bfloat16: ("flash_fwd_sm90", "repro_flash_fwd_sm90", 128)}
# kernel A at (q/k, v) head dims other than one D, by dtype: (library,
# entry point, q rows a tile, keys a tile); it takes these (Dk, Dv) pairs.
# The bf16 route's rows are (position, head) pairs: 64 // G positions of a
# group of G heads (latent_tile); with a v of its own (not k's prefix view)
# it takes LATENT_OWN_V_KEYS keys a tile, so that two stages of k and v fit
LATENT_ROUTES = {
    torch.float32: ("flash_fwd_latent", "repro_flash_fwd_latent", 16, 32),
    torch.bfloat16: ("flash_fwd_latent_sm90", "repro_flash_fwd_latent_sm90",
                     64, 64)}
LATENT_OWN_V_KEYS = 32
# the bf16 latent route cuts a tile's kv sweep into parts of at least this
# many kv tiles (latent_splits)
LATENT_SPLIT_TILES = 4
LATENT_DIMS = ((576, 512),)
# kernel A at these (Dk, Dv) pairs, by dtype: (library, entry point, q rows
# a tile, keys a tile)
PAIR_ROUTES = {
    torch.float32: ("flash_fwd_latent", "repro_flash_fwd_latent", 16, 32),
    torch.bfloat16: ("flash_fwd_pair_sm90", "repro_flash_fwd_pair_sm90",
                     128, 64)}
PAIR_DIMS = ((192, 128),)
# kernels C and D: (library, entry-point suffix) by dtype
BWD_ROUTES = {torch.float32: ("flash_bwd", ""),
              torch.bfloat16: ("flash_bwd_sm90", "_sm90")}
# kernels C and D at the pairs of PAIR_DIMS, by dtype
PAIR_BWD_ROUTES = {torch.float32: ("flash_bwd", ""),
                   torch.bfloat16: ("flash_bwd_pair_sm90", "_pair_sm90")}

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


def latent_tile(group: int, rows: int = 64):
    """(positions, heads) of one ``rows``-row tile of (position, head)
    pairs over a GQA group of ``group`` query heads: ``rows // group``
    positions of the whole group, or ``rows`` heads of one position when
    the group is a multiple of ``rows``.  Any other group raises."""
    if rows % group == 0:
        return rows // group, group
    if group % rows == 0:
        return 1, rows
    raise ValueError(f"the bf16 latent route tiles {rows} (position, head) "
                     f"rows: a GQA group of {group} heads neither divides "
                     f"{rows} nor is a multiple of it")


def tile_bounds(mask: MaskSpec, Tq: int, Tk: int, prune: bool = True,
                br: int = BLOCK_Q, bc: int = BLOCK_KV):
    """Per ``br``-row q tile ``(lo, hi, interior_lo, interior_hi)`` of
    ``bc``-key tiles, as a list of tuples (host-side sweep plan of kernels A
    and C)."""
    nq, nk = -(-Tq // br), -(-Tk // bc)
    rows = []
    for i in range(nq):
        if not prune:
            rows.append((0, nk - 1, 1, 0))
            continue
        lo, hi = (kv_block_bounds(i, br=br, bc=bc, nk=nk, mask=mask)
                  if mask.prunable else (0, nk - 1))
        ilo, ihi = interior_kv_bounds(i, br=br, bc=bc, nk=nk, mask=mask)
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
                   device: str, block: int = BLOCK_Q, bc: int = 0):
    """The sweep table on ``device`` at ``block``-row q tiles of ``bc``-key
    tiles (``block`` when 0: 64 for kernels C, D and A's float32 route, 128
    for A's bf16 route; 16 × 32 for A's float32 latent route; 64 // G
    positions × 64 keys for its bf16 one; each size is its own cache
    entry), and whether it is empty."""
    rows = tile_bounds(mask, Tq, Tk, prune, br=block, bc=bc or block)
    empty = all(hi < lo for lo, hi, _, _ in rows)
    t = torch.tensor(rows, dtype=torch.int32).to(device)
    return t, empty


@functools.lru_cache(maxsize=256)
def _device_q_bounds(mask: MaskSpec, Tq: int, Tk: int, prune: bool,
                     device: str):
    rows = q_tile_bounds(mask, Tq, Tk, prune)
    return torch.tensor(rows, dtype=torch.int32).to(device)


def _check(q, k, v, latent: bool = False, **more):
    """Device, dtype, layout and head dims of a flash call; ``more`` holds
    the backward's o and do, (B, Tq, Hq, Dv).  One head dim of
    ``HEAD_DIMS`` for q, k and v, or q/k and v pairs: ``PAIR_DIMS`` (the
    forward and the backward), ``LATENT_DIMS`` (the forward, ``latent``:
    absorbed MLA, which is never trained)."""
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
    Dv = v.shape[-1]
    one_d = D in HEAD_DIMS and Dv == D
    pairs = LATENT_DIMS + PAIR_DIMS if latent else PAIR_DIMS
    if k.shape[-1] != D or not (one_d or (D, Dv) in pairs):
        raise ValueError(f"each flash kernel takes head dims {HEAD_DIMS} "
                         f"(equal for q, k, v) or q/k and v pairs {pairs}"
                         f"{'' if latent else ' (backward)'}, got "
                         f"{D}/{k.shape[-1]}/{Dv}")
    if k.shape[:3] != v.shape[:3] or k.shape[0] != B:
        raise ValueError(f"k/v shapes {tuple(k.shape)} {tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if Hq % k.shape[2]:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={k.shape[2]}")
    for name, t in more.items():
        if t.shape != (B, Tq, Hq, Dv):
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{(B, Tq, Hq, Dv)}")


def _check_aligned(**tensors):
    """The tensor-core routes copy rows in 16-byte pieces: every row of
    every head must start on a 16-byte boundary."""
    for name, t in tensors.items():
        step = 16 // t.element_size()
        if t.data_ptr() % 16 or any(s % step for s in t.stride()[:3]):
            raise ValueError(f"{name}: the bf16 kernels need 16-byte "
                             f"aligned rows (pointer {t.data_ptr() % 16} "
                             f"bytes past 16, strides {t.stride()})")


def _segments(mask: MaskSpec, segs, T: int, offset: int, device):
    """(segment tensor, batch stride): the caller's (B, T) ids, or the static
    boundaries' ids broadcast over the batch (stride 0)."""
    if segs is not None:
        s = segs.to(device=device, dtype=torch.int32).contiguous()
        return s, s.stride(0)
    pos = offset + torch.arange(T, device=device)
    return mask.segment_of(pos).contiguous(), 0


def latent_splits(blocks: int, longest: int, sms: int) -> int:
    """Parts each tile's kv sweep of the bf16 latent route is cut into
    (their partial o and lse merged by a second kernel): enough for a block
    on every SM when the tiles alone leave half of them idle, with at least
    ``LATENT_SPLIT_TILES`` kv tiles in the longest sweep's parts."""
    if 2 * blocks > sms:
        return 1
    return max(1, min(sms // blocks, longest // LATENT_SPLIT_TILES))


@functools.lru_cache(maxsize=256)
def _longest_sweep(mask: MaskSpec, Tq: int, Tk: int, prune: bool, br: int,
                   bc: int) -> int:
    return max([hi - lo + 1 for lo, hi, _, _ in
                tile_bounds(mask, Tq, Tk, prune, br=br, bc=bc)] + [0])


@functools.lru_cache(maxsize=8)
def _sm_count(device: str) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _flash_fwd_cuda(q, k, v, mask, scale, q_segments, kv_segments, prune):
    _check(q, k, v, latent=True)
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    latent = (D, Dv) in LATENT_DIMS
    tc_latent = latent and q.dtype == torch.bfloat16
    count = ("flash_fwd_latent" if latent else "flash_fwd_pair" if Dv != D
             else f"flash_fwd_{D}" if D in WIDE_DIMS else "flash_fwd")
    if Dv != D or (D in WIDE_DIMS and q.dtype == torch.bfloat16):
        lib, name, block, bc = (LATENT_ROUTES if latent
                                else PAIR_ROUTES)[q.dtype]
        _check_aligned(q=q, k=k, v=v)
        # the latent pool's value view: v is k's first Dv columns
        v_in_k = v.data_ptr() == k.data_ptr() and v.stride() == k.stride()
        extra = (Dv, v_in_k)
        if tc_latent:
            block, heads = latent_tile(Hq // Hkv, block)
            bc = bc if v_in_k else LATENT_OWN_V_KEYS
    else:
        lib, name, block = FWD_ROUTES[q.dtype]
        bc, extra = block, ()
        if q.dtype == torch.bfloat16:
            _check_aligned(q=q, k=k, v=v)
    dev = str(q.device)
    bounds, empty = _device_bounds(mask, Tq, Tk, bool(prune), dev, block, bc)
    o_shape = (B, Tq, Hq, Dv)
    if empty:                            # statically fully masked chunk
        return (torch.zeros(o_shape, dtype=q.dtype, device=q.device),
                torch.full((B, Tq, Hq), NEG_INF, dtype=torch.float32,
                           device=q.device))
    qs = ks = None
    qs_sb = ks_sb = 0
    if mask.document:
        qs, qs_sb = _segments(mask, q_segments, Tq, mask.q_offset, q.device)
        ks, ks_sb = _segments(mask, kv_segments, Tk, mask.kv_offset, q.device)
    o = torch.empty(o_shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Tq, Hq), dtype=torch.float32, device=q.device)
    parts = ()
    if tc_latent:       # the sweep's parts, and room for their partials
        n = latent_splits(bounds.shape[0] * (Hq // heads) * B,
                          _longest_sweep(mask, Tq, Tk, bool(prune), block,
                                         bc), _sm_count(dev))
        o_part = lse_part = None
        if n > 1:       # one allocation: o's parts, then lse's
            rows = n * B * Tq * Hq
            buf = torch.empty(rows * (Dv + 1), dtype=torch.float32,
                              device=q.device)
            o_part, lse_part = buf[:rows * Dv], buf[rows * Dv:]
        extra += (n,)
        parts = (build.ptr(o_part), build.ptr(lse_part))
    ia = build.int64_args(
        B, Tq, Tk, Hq, Hkv, D, DTYPES[q.dtype], bounds.shape[0],
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        mask.causal, mask.window, mask.prefix_len, mask.q_offset,
        mask.kv_offset, mask.document, qs_sb, ks_sb, mask.needs_mask,
        *extra)
    err = _entry(lib, name, 8 + len(parts))(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(o),
        build.ptr(lse), build.ptr(bounds), build.ptr(qs), build.ptr(ks),
        *parts, ia, float(scale), build.stream_ptr(q.device))
    if err:
        raise RuntimeError(f"flash_fwd kernel launch failed ({lib}, CUDA "
                           f"error {err})")
    build.LAUNCHES[count] += 1
    return o, lse


def flash_fwd(q, k, v, *, mask: MaskSpec | None = None,
              scale: float | None = None, q_segments=None, kv_segments=None,
              prune: bool = True):
    """(B,T,H,D) partial attention -> (o (B,Tq,Hq,Dv), lse (B,Tq,Hq) f32);
    the default scale is 1/√D of q."""
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
        compute_delta, v.shape[-1])


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
        D, Dv = q.shape[-1], v.shape[-1]
        wide = Dv == D and D in WIDE_DIMS
        routes = PAIR_BWD_ROUTES if Dv != D or wide else BWD_ROUTES
        self.lib, self.suffix = routes[q.dtype]
        self.count = f"_{D}" if wide else ""
        if q.dtype == torch.bfloat16:
            _check_aligned(q=q, k=k, v=v, o=o, do=do)


def _launch_dq(pl: _BwdPlan, scale):
    """Kernel C: dq (and delta, unless it was passed in)."""
    q = pl.q
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    ia = _bwd_args(q, pl.k, pl.v, pl.o, pl.do, dq, None, None, pl.mask,
                   pl.qs_sb, pl.ks_sb, pl.nq, pl.nk, pl.compute_delta)
    err = _entry(pl.lib, "repro_flash_bwd_dq" + pl.suffix, 11)(
        build.ptr(q), build.ptr(pl.k), build.ptr(pl.v), build.ptr(pl.o),
        build.ptr(pl.do), build.ptr(pl.lse), build.ptr(pl.delta),
        build.ptr(dq), build.ptr(pl.bounds), build.ptr(pl.qs),
        build.ptr(pl.ks), ia, float(scale), build.stream_ptr(q.device))
    if err:
        raise RuntimeError(f"flash_bwd dq kernel launch failed (CUDA error "
                           f"{err})")
    build.LAUNCHES["flash_bwd_dq" + pl.count] += 1
    return dq


def _launch_dkv(pl: _BwdPlan, scale):
    """Kernel D: dk and dv, summed over each GQA group on chip."""
    k, v = pl.k, pl.v
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)   # contiguous
    ia = _bwd_args(pl.q, k, v, None, pl.do, None, dk, dv, pl.mask, pl.qs_sb,
                   pl.ks_sb, pl.nq, pl.nk, 0)
    err = _entry(pl.lib, "repro_flash_bwd_dkv" + pl.suffix, 12)(
        build.ptr(pl.q), build.ptr(k), build.ptr(v), build.ptr(pl.do),
        build.ptr(pl.lse), build.ptr(pl.delta), build.ptr(dk),
        build.ptr(dv), build.ptr(pl.bounds), build.ptr(pl.q_bounds),
        build.ptr(pl.qs), build.ptr(pl.ks), ia, float(scale),
        build.stream_ptr(k.device))
    if err:
        raise RuntimeError(f"flash_bwd dkv kernel launch failed (CUDA error "
                           f"{err})")
    build.LAUNCHES["flash_bwd_dkv" + pl.count] += 1
    return dk, dv


def flash_bwd(q, k, v, o, lse, do, *, mask: MaskSpec | None = None,
              scale: float | None = None, delta=None, q_segments=None,
              kv_segments=None, prune: bool = True):
    """Backward of :func:`flash_fwd` from its saved ``(o, lse)``, in the
    (B, T, H, D) layout: returns (dq, dk, dv) in the dtypes of q, k, v,
    with dk/dv summed over each GQA group.  ``delta = rowsum(o ⊙ do)``
    (B, Tq, Hq) may be passed precomputed.  One head dim of ``HEAD_DIMS``,
    or q/k and v of ``PAIR_DIMS`` (o and do then (B, Tq, Hq, Dv)); the
    default scale is 1/√D of q."""
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

"""Kernel B — paged flash-decode attention through a block table (the port
of the reference's ``_paged_kernel`` / ``paged_attn_pallas``,
``kernels/paged.py``).

Layout (the reference's):

  q            (B, Tq, Hq, D)     row ``t`` of request ``b`` sits at context
                                  position ``lengths[b] − Tq + t``
  k_pool       (N, bs, Hkv, D)    one layer's key pool (N = pool blocks)
  v_pool       (N, bs, Hkv, Dv)   Dv = D, or (absorbed MLA) a narrow view
                                  of the latent k_pool: D 576, Dv 512
  block_table  (B, nb) int32      request b's i-th block id (0 = the reserved
                                  null block)
  lengths      (B,) int32         attendable tokens incl. the new ones

The mask is ``causal`` or ``sliding_window``, evaluated per row against
``lengths``.  :func:`paged_attn_ref` is the plain PyTorch version (gather
the whole table, materialise the scores); :func:`paged_attn` runs it for
CPU tensors and launches the hand-written kernel (``csrc/paged_decode.cu``)
for CUDA tensors, or raises.

The kernel splits each request's context into splits of ``L_s`` tokens
(:func:`split_plan`: a whole number of pages, fixed per head dim and
dtype, ``S`` splits from the table's width), sweeps each live split in its
own thread block and merges the splits' partial results in a fixed order.
:func:`paged_attn_split_ref` is the same split-and-merge arithmetic in
plain PyTorch, for the tests.

Head dims: one D of ``HEAD_DIMS`` for q, k and v, or a (D, Dv) pair of
``LATENT_DIMS`` — the latent pool of absorbed MLA, whose value pool the
kernel reads from the staged key rows when it is a prefix view of the key
pool (same pointer and strides).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.mask import MaskSpec, causal
from repro_torch.kernels import build
from repro_torch.kernels.ref import NEG_INF

HEAD_DIMS = (32, 64, 128)
LATENT_DIMS = ((576, 512),)     # (q/k, v) head dims of the latent pool
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_SIZES = (8, 64)           # inclusive range the kernel takes
# tokens a split aims at, per (dtype, head dim): 64 KB of K a split for one
# kv head (32 KB at bf16 D 32, capped at 512 tokens); a split is then
# rounded up to whole pages.  256 tokens at bf16 D 128 balances the serving
# step's few hundred blocks against the per-block start-up of a long
# request (PERF.md).  The latent shape (D 576) takes 32 tokens a split:
# one tile of its 68 KB ring stage, and the most blocks for a serving
# step's few thousand tokens (one kv head).
SPLIT_TOKENS = {(torch.bfloat16, 128): 256, (torch.bfloat16, 64): 512,
                (torch.bfloat16, 32): 512, (torch.float32, 128): 128,
                (torch.float32, 64): 256, (torch.float32, 32): 512,
                (torch.bfloat16, 576): 32, (torch.float32, 576): 32}

_FN = []


def _fn():
    if not _FN:
        f = build.load("paged_decode").repro_paged_decode
        f.argtypes = [ctypes.c_void_p] * 8 + [
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


def split_plan(nb: int, bs: int, D: int, dtype) -> tuple:
    """(L_s, S): the split length in tokens, a whole number of ``bs``-token
    pages, and the number of splits that cover a table ``nb`` pages wide.
    Boundaries depend on (bs, D, dtype) only, never on the batch, the
    table's width or the lengths, so a request's result does not depend on
    what it is batched with.  ``D`` is the q/k head dim."""
    target = SPLIT_TOKENS[(dtype, D)]
    Ls = -(-target // bs) * bs
    return Ls, max(1, -(-(nb * bs) // Ls))


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


def paged_attn_split_ref(q, k_pool, v_pool, block_table, lengths, *,
                         mask: MaskSpec | None = None, scale=None,
                         split_tokens: int | None = None):
    """Plain version of the kernel's split-and-merge arithmetic: each
    request's live splits of ``L_s`` tokens (:func:`split_plan`, or
    ``split_tokens`` rounded up to whole pages) are attended on their own,
    giving a normalised partial o_s and its lse_s, and merged in split order
    with the reference's NEG_INF rules (``kernels/ref.merge_ref``).  A
    request's arithmetic has the same shapes whatever the batch and the
    table's width.  Returns o (B, Tq, Hq, Dv)."""
    mask = causal() if mask is None else mask
    _check(q, k_pool, v_pool, block_table, lengths, mask)
    B, Tq, Hq, D = q.shape
    Dv = v_pool.shape[-1]
    nb = block_table.shape[1]
    bs, Hkv = k_pool.shape[1], k_pool.shape[2]
    g = Hq // Hkv
    sc = scale if scale is not None else 1.0 / (D ** 0.5)
    if split_tokens is None:
        Ls, _ = split_plan(nb, bs, D, q.dtype)
    else:
        Ls = -(-split_tokens // bs) * bs
    P = Ls // bs
    out = torch.zeros((B, Tq, Hq, Dv), dtype=torch.float32, device=q.device)
    t_rows = torch.arange(Tq, device=q.device)
    for b in range(B):
        # [t_lo, t_hi): the context positions some row of the request sees
        length = int(lengths[b])
        t_lo = max(0, length - Tq - mask.window + 1) if mask.window else 0
        t_hi = min(length, nb * bs)
        if t_hi <= t_lo:
            continue
        parts = []
        for s in range(t_lo // Ls, -(-t_hi // Ls)):
            pages = block_table[b, s * P:(s + 1) * P].long()
            kk = k_pool[pages].reshape(-1, Hkv, D).float()
            vv = v_pool[pages].reshape(-1, Hkv, Dv).float()
            pad = Ls - kk.shape[0]            # pages past the table's width
            if pad:
                kk = torch.cat([kk, kk.new_zeros((pad, Hkv, D))])
                vv = torch.cat([vv, vv.new_zeros((pad, Hkv, Dv))])
            if g > 1:
                kk = kk.repeat_interleave(g, dim=1)
                vv = vv.repeat_interleave(g, dim=1)
            tok = s * Ls + torch.arange(Ls, device=q.device)
            qpos = length - Tq + t_rows
            ok = ((tok[None] >= t_lo) & (tok[None] < t_hi)
                  & (tok[None] <= qpos[:, None]))
            if mask.window:
                ok = ok & (tok[None] > qpos[:, None] - mask.window)
            sc_ = torch.einsum("thd,khd->htk", q[b].float(), kk) * sc
            sc_ = torch.where(ok[None], sc_, torch.full_like(sc_, NEG_INF))
            m = sc_.amax(dim=-1)                                  # (Hq, Tq)
            empty = m <= NEG_INF / 2
            p = torch.exp(sc_ - torch.where(empty, 0.0, m)[..., None])
            p = torch.where(empty[..., None], torch.zeros_like(p), p)
            den = p.sum(dim=-1)
            o_s = torch.einsum("htk,khd->thd", p, vv)
            den_t = den.transpose(0, 1)[..., None]               # (Tq, Hq, 1)
            o_s = torch.where(den_t == 0.0, torch.zeros_like(o_s),
                              o_s / torch.where(den_t == 0.0, 1.0, den_t))
            lse = torch.where(den == 0.0, torch.full_like(den, NEG_INF),
                              m + torch.log(torch.where(den == 0.0, 1.0,
                                                        den)))
            parts.append((o_s, lse.transpose(0, 1)))              # (Tq, Hq)
        if len(parts) == 1:
            out[b] = parts[0][0]
            continue
        mx = torch.stack([ls for _, ls in parts]).amax(dim=0)
        live = mx > NEG_INF / 2
        num = torch.zeros_like(parts[0][0])
        den = torch.zeros_like(mx)
        for o_s, ls in parts:
            w = torch.where(live & (ls > NEG_INF / 2),
                            torch.exp(ls - torch.where(live, mx, 0.0)),
                            torch.zeros_like(ls))
            den = den + w
            num = num + w[..., None] * o_s
        out[b] = torch.where(den[..., None] == 0.0, torch.zeros_like(num),
                             num / torch.where(den == 0.0, 1.0,
                                               den)[..., None])
    return out.to(q.dtype)


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
    D, Dv = q.shape[-1], v_pool.shape[-1]
    if k_pool.shape[-1] != D or not (D in HEAD_DIMS and Dv == D
                                     or (D, Dv) in LATENT_DIMS):
        raise ValueError(f"paged decode kernel takes head dims {HEAD_DIMS} "
                         f"or (q/k, v) pairs {LATENT_DIMS}, got "
                         f"{D}/{k_pool.shape[-1]}/{Dv}")
    bs = k_pool.shape[1]
    if not BLOCK_SIZES[0] <= bs <= BLOCK_SIZES[1]:
        raise ValueError(f"paged decode kernel takes block sizes "
                         f"{BLOCK_SIZES[0]}..{BLOCK_SIZES[1]}, got {bs}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.ndim != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be 4-d with a unit-stride last "
                             f"dim, got strides {t.stride()}")
    # the kernel stages pool rows with 16-byte cp.async copies
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        step = 16 // t.element_size()
        if t.data_ptr() % 16 or any(st % step for st in t.stride()[:3]):
            raise ValueError(f"{name}: paged decode needs 16-byte aligned "
                             f"rows (pointer {t.data_ptr() % 16} bytes past "
                             f"16, strides {t.stride()})")
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
    """Paged decode attention: plain version on the CPU, kernel B on CUDA.
    Returns o (B, Tq, Hq, Dv)."""
    mask = causal() if mask is None else mask
    if q.device.type == "cpu":
        return paged_attn_ref(q, k_pool, v_pool, block_table, lengths,
                              mask=mask, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attn runs on cpu or cuda, got {q.device}")
    _check(q, k_pool, v_pool, block_table, lengths, mask)
    _check_cuda(q, k_pool, v_pool, block_table, lengths, mask)
    B, Tq, Hq, D = q.shape
    Dv = v_pool.shape[-1]
    bs, Hkv = k_pool.shape[1], k_pool.shape[2]
    nb = block_table.shape[1]
    sc = scale if scale is not None else 1.0 / (D ** 0.5)
    Ls, S = split_plan(nb, bs, D, q.dtype)
    o = torch.empty((B, Tq, Hq, Dv), dtype=q.dtype, device=q.device)
    o_part = lse_part = None
    if S > 1:       # the splits' partial (o_s, lse_s), in one allocation
        rows = B * S * Hq * Tq
        part = torch.empty(rows * (Dv + 1), dtype=torch.float32,
                           device=q.device)
        o_part, lse_part = part[:rows * Dv], part[rows * Dv:]
    v_in_k = (v_pool.data_ptr() == k_pool.data_ptr()
              and v_pool.stride() == k_pool.stride())
    ia = build.int64_args(
        B, Tq, Hq, Hkv, D, DTYPES[q.dtype], bs, nb, mask.window,
        *q.stride()[:3], *k_pool.stride()[:3], *v_pool.stride()[:3],
        *o.stride()[:3], block_table.stride(0), Ls, S, Dv, v_in_k)
    err = _fn()(build.ptr(q), build.ptr(k_pool), build.ptr(v_pool),
                 build.ptr(o), build.ptr(o_part), build.ptr(lse_part),
                 build.ptr(block_table), build.ptr(lengths), ia, float(sc),
                 build.stream_ptr(q.device))
    if err:
        raise RuntimeError(f"paged_decode kernel launch failed (CUDA error "
                           f"{err})")
    build.LAUNCHES["paged_decode"] += 1
    return o

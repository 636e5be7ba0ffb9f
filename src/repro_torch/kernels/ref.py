"""Plain PyTorch oracle for chunk attention, forward and backward (port of
the reference ``kernels/ref.py``).

Partial (chunk) attention: for one query chunk and one key/value chunk with
absolute position offsets, return the output **and the log-sum-exp** of the
masked scores, so partials over different KV chunks merge exactly.

Empty-row contract, relied on by every merge: a row with nothing to attend
gets ``o = 0`` and ``lse = NEG_INF``.
"""
from __future__ import annotations

import torch

from repro_torch.core.mask import MaskSpec, full

NEG_INF = -1e30  # large-negative instead of -inf: keeps exp() NaN-free


def _allow(spec: MaskSpec, Tq, Tk, device, q_segments, kv_segments):
    """Attend-mask (Tq, Tk) or (B, Tq, Tk), or None when nothing is masked."""
    if not spec.needs_mask:
        return None
    q_pos = spec.q_offset + torch.arange(Tq, device=device)
    kv_pos = spec.kv_offset + torch.arange(Tk, device=device)
    qs = ks = None
    if spec.document and q_segments is not None and kv_segments is not None:
        qs = q_segments[:, :, None]                    # (B, Tq, 1)
        ks = kv_segments[:, None, :]                   # (B, 1, Tk)
    return spec.allow(q_pos[:, None], kv_pos[None, :], qs, ks)


def chunk_attn_ref(q, k, v, *, mask: MaskSpec | None = None,
                   scale: float | None = None, q_segments=None,
                   kv_segments=None):
    """Partial attention over one (q-chunk, kv-chunk) pair.

    q: (B, Tq, Hq, D); k, v: (B, Tk, Hkv, Dk/Dv), Hq % Hkv == 0 (GQA).
    Returns o (B, Tq, Hq, Dv) in q's dtype and lse (B, Tq, Hq) float32.
    """
    spec = full() if mask is None else mask
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    qf, kf, vf = q.float(), k.float(), v.float()
    if g > 1:
        kf = kf.repeat_interleave(g, dim=2)
        vf = vf.repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    m = _allow(spec, Tq, Tk, q.device, q_segments, kv_segments)
    if m is not None:
        m = m[None, None] if m.ndim == 2 else m[:, None]
        s = torch.where(m, s, torch.full_like(s, NEG_INF))
    mx = s.amax(dim=-1)                                # (B,H,Tq)
    mx_safe = torch.clamp(mx, min=NEG_INF / 2)
    p = torch.exp(s - mx_safe[..., None])
    l = p.sum(dim=-1)
    empty = mx <= NEG_INF / 2
    lse = torch.where(empty, torch.full_like(mx, NEG_INF),
                      mx_safe + torch.log(l))
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    denom = torch.where(l == 0.0, torch.ones_like(l), l)
    o = o / denom.transpose(1, 2)[..., None]
    o = torch.where(empty.transpose(1, 2)[..., None], torch.zeros_like(o), o)
    return o.to(q.dtype), lse.transpose(1, 2).contiguous()


def chunk_attn_bwd_ref(q, k, v, o, lse, do, *, mask: MaskSpec | None = None,
                       scale: float | None = None, delta=None,
                       q_segments=None, kv_segments=None, only=None):
    """FlashAttention-2 backward of one chunk from the saved (o, lse).

    ``delta = rowsum(o ⊙ do)`` (B, Tq, Hq) may be passed precomputed.  A
    row whose lse is NEG_INF (nothing to attend) contributes nothing.
    Returns (dq, dk, dv) in the dtypes of q, k, v; dk/dv are summed over
    each GQA group.  ``only="dq"`` or ``only="dkv"`` computes just that
    part (the others are None): the plain version of kernel C or D alone.
    """
    if only not in (None, "dq", "dkv"):
        raise ValueError(f"only must be None, 'dq' or 'dkv', got {only!r}")
    spec = full() if mask is None else mask
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    qf, kf, vf = q.float(), k.float(), v.float()
    of, dof = o.float(), do.float()
    kr = kf.repeat_interleave(g, dim=2) if g > 1 else kf
    vr = vf.repeat_interleave(g, dim=2) if g > 1 else vf
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kr) * scale
    m = _allow(spec, Tq, Tk, q.device, q_segments, kv_segments)
    if m is not None:
        m = m[None, None] if m.ndim == 2 else m[:, None]
        s = torch.where(m, s, torch.full_like(s, NEG_INF))
    lse_b = lse.float().transpose(1, 2)[..., None]       # (B,H,Tq,1)
    p = torch.where(lse_b <= NEG_INF / 2, torch.zeros_like(s),
                    torch.exp(s - lse_b))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vr)
    if delta is None:
        delta = (of * dof).sum(dim=-1)                   # (B,Tq,H)
    dlt = delta.float().transpose(1, 2)[..., None]       # (B,H,Tq,1)
    ds = p * (dp - dlt) * scale
    dq = dk = dv = None
    if only != "dkv":
        dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr).to(q.dtype)
    if only != "dq":
        dv_h = torch.einsum("bhqk,bqhd->bkhd", p, dof)
        dk_h = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
        if g > 1:
            dk_h = dk_h.reshape(B, Tk, Hkv, g, D).sum(dim=3)
            dv_h = dv_h.reshape(B, Tk, Hkv, g, -1).sum(dim=3)
        dk, dv = dk_h.to(k.dtype), dv_h.to(v.dtype)
    return dq, dk, dv


def row_rel_err(a, r, floor: float = 1e-3) -> float:
    """Largest per-row relative error ‖a_row − r_row‖ / (‖r_row‖ + floor ·
    max ‖r_row‖) over the last axis: a row is one query's dq, or one key's
    dk / dv, in one head.  The bar for a bf16 backward whose second
    products take p and ds rounded to bf16 (as every tensor-core backward
    does): that rounding moves single elements of a row by far more than
    one bf16 step of their own size, but each row only by ~2^-8 of its
    norm, while a sweep that skips a key tile moves whole rows."""
    a, r = a.float(), r.float()
    dn = (a - r).norm(dim=-1)
    rn = r.norm(dim=-1)
    den = rn + floor * rn.max().clamp_min(1e-30)
    return float((dn / den).max())


def merge_ref(o1, lse1, o2, lse2):
    """Exact online-softmax merge of two partial results.  o (B,T,H,D),
    lse (B,T,H)."""
    mx = torch.clamp(torch.maximum(lse1, lse2), min=NEG_INF)
    w1 = torch.exp(lse1 - mx)
    w2 = torch.exp(lse2 - mx)
    den = w1 + w2
    den_safe = torch.where(den == 0.0, torch.ones_like(den), den)
    o = (o1.float() * w1[..., None] + o2.float() * w2[..., None]) \
        / den_safe[..., None]
    lse = torch.where(den == 0.0, torch.full_like(den, NEG_INF),
                      mx + torch.log(den_safe))
    return o.to(o1.dtype), lse

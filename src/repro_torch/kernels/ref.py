"""Plain PyTorch oracle for chunk attention (port of the reference
``kernels/ref.py``).

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

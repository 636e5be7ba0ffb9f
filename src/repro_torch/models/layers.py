"""Transformer building blocks (port of the reference ``models/layers.py``).

Parameters are plain dicts of tensors.  The casts sit where the reference
puts them, which is what bf16 parity depends on: ``rms_norm`` casts back to
the input dtype *before* multiplying by ``w``; ``attn_out`` and
``mlp_apply`` cast the projected update *after* the product.  ``apply_rope``
rotates interleaved pairs ``(x[2i], x[2i+1])``, not halves.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.config import ModelConfig


def rms_norm(x, w, eps=1e-5):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope_tables(positions, dim, theta=10_000.0):
    """cos/sin tables: positions (T,) -> (T, dim/2) float32."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, device=positions.device,
                                        dtype=torch.float32) / dim))
    ang = positions.float()[:, None] * inv[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B,T,H,D); cos/sin: (T, D/2) shared tables or (B, T, D/2)
    per-request tables.  Rotates pairs (x[2i], x[2i+1])."""
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    if cos.ndim == 3:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    else:
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    r1 = x1 * c - x2 * s
    r2 = x2 * c + x1 * s
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def attn_qkv(p, x, cfg: ModelConfig, cos, sin):
    """Norm → q/k/v projections → rope.  x: (B,T,d)."""
    a = cfg.attn
    B, T, _ = x.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q = (h @ p["wq"]).reshape(B, T, a.n_heads, a.head_dim)
    k = (h @ p["wk"]).reshape(B, T, a.n_kv_heads, a.head_dim)
    v = (h @ p["wv"]).reshape(B, T, a.n_kv_heads, a.head_dim)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def attn_out(p, x, o, cfg: ModelConfig):
    """Residual add of the output projection.  o: (B,T,H,hd)."""
    B, T = x.shape[:2]
    return x + (o.reshape(B, T, -1) @ p["wo"]).to(x.dtype)


def mlp_apply(p, x, eps=1e-5):
    """SwiGLU MLP with pre-norm and residual."""
    h = rms_norm(x, p["ln"], eps)
    return x + ((F.silu(h @ p["wg"]) * (h @ p["wu"])) @ p["wd"]).to(x.dtype)


def embed(table, tokens, dtype):
    """Embedding gather: (B, T) int tokens -> (B, T, d)."""
    return table[tokens.long()].to(dtype)


def cross_entropy_sum(logits, labels):
    """(sum of token cross-entropies in float32, number of tokens counted);
    labels == -100 are ignored."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    labels = labels.long()
    ll = lf.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    w = (labels >= 0).float()
    return ((lse - ll) * w).sum(), w.sum()


def cross_entropy(logits, labels):
    """Mean token cross-entropy in float32; labels == -100 are ignored."""
    s, n = cross_entropy_sum(logits, labels)
    return s / n.clamp(min=1.0)

"""Transformer building blocks (port of the reference ``models/layers.py``).

Parameters are plain dicts of tensors.  The casts sit where the reference
puts them, which is what bf16 parity depends on: ``rms_norm`` casts back to
the input dtype *before* multiplying by ``w``; ``attn_out`` and
``mlp_apply`` cast the projected update *after* the product.  ``apply_rope``
rotates interleaved pairs ``(x[2i], x[2i+1])``, not halves.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.config import ModelConfig


def rms_norm(x, w, eps=1e-5):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def head_rms_norm(x, w, eps=1e-5):
    """Qwen3 qk-norm: RMSNorm over the head dim of (B, T, H, D)."""
    return rms_norm(x, w, eps)


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
    """Norm → q/k/v projections (+ ``bq``/``bk``/``bv`` under ``qkv_bias``,
    in the projection's dtype) → qk-norm (``qk_norm``) → rope.
    x: (B,T,d)."""
    a = cfg.attn
    B, T, _ = x.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k, v = h @ p["wq"], h @ p["wk"], h @ p["wv"]
    if a.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, T, a.n_heads, a.head_dim)
    k = k.reshape(B, T, a.n_kv_heads, a.head_dim)
    v = v.reshape(B, T, a.n_kv_heads, a.head_dim)
    if a.qk_norm:
        q = head_rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = head_rms_norm(k, p["k_norm"], cfg.norm_eps)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def attn_out(p, x, o, cfg: ModelConfig):
    """Residual add of the output projection.  o: (B,T,H,hd)."""
    B, T = x.shape[:2]
    return x + (o.reshape(B, T, -1) @ p["wo"]).to(x.dtype)


def mla_qkv(p, x, cfg: ModelConfig, cos, sin, return_latent=False):
    """DeepSeek multi-head latent attention [arXiv:2405.04434], the
    materialised form: norm → q (``wq``, or ``wq_a`` → ``q_ln`` → ``wq_b``
    under ``q_lora_rank``) and the latent ``wkv_a`` → (``kv_ln``-normed
    c_kv, rope key) → per-head k/v up-projected by ``wkv_b``.  Returns q, k
    (B, T, H, nope + rope) and v (B, T, H, v_head_dim); ``cos``/``sin``
    are rope tables of ``qk_rope_head_dim``.  ``return_latent`` also
    returns the latent rows (B, T, kv_lora + rope), normed c_kv ⊕ roped
    k_pe: the dense decode cache the whole-prompt prefill keeps.  The paged
    serving path attends in latent space instead (``DecoderLM._mla_parts``);
    this form is the training and whole-prompt prefill one, and the oracle
    of the absorption."""
    a = cfg.attn
    B, T, _ = x.shape
    nh, dn, dr = a.n_heads, a.qk_nope_head_dim, a.qk_rope_head_dim
    dv = a.v_head_dim or a.head_dim
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    if a.q_lora_rank:
        qc = rms_norm(h @ p["wq_a"], p["q_ln"], cfg.norm_eps)
        q = (qc @ p["wq_b"]).reshape(B, T, nh, dn + dr)
    else:
        q = (h @ p["wq"]).reshape(B, T, nh, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    kv_a = h @ p["wkv_a"]
    c_kv = rms_norm(kv_a[..., :a.kv_lora_rank], p["kv_ln"], cfg.norm_eps)
    k_pe = kv_a[..., a.kv_lora_rank:].reshape(B, T, 1, dr)
    q_pe = apply_rope(q_pe, cos, sin)
    k_pe = apply_rope(k_pe, cos, sin)
    kv = (c_kv @ p["wkv_b"]).reshape(B, T, nh, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q_full = torch.cat([q_nope, q_pe], dim=-1)
    k_full = torch.cat([k_nope, k_pe.expand(B, T, nh, dr)], dim=-1)
    if return_latent:
        return q_full, k_full, v, torch.cat([c_kv, k_pe[:, :, 0]], dim=-1)
    return q_full, k_full, v


def mla_expand(latent, w_up, cfg: ModelConfig):
    """The receive side of the MLA latent ring (``core/dist_attention.
    dist_attn_fwd_latent``): latent rows (B, T, kv_lora + rope) — normed
    c_kv ⊕ roped k_pe, :func:`mla_qkv`'s ``return_latent`` — up-projected
    by ``w_up`` (``wkv_b``, kv_lora × H·(nope + v)) into per-head k (B, T,
    H, nope + rope), the one k_pe broadcast over the heads, and v (B, T,
    H, v_head_dim)."""
    a = cfg.attn
    B, T, _ = latent.shape
    nh, dn, dr = a.n_heads, a.qk_nope_head_dim, a.qk_rope_head_dim
    dv = a.v_head_dim or a.head_dim
    c_kv, k_pe = latent[..., :a.kv_lora_rank], latent[..., a.kv_lora_rank:]
    kv = (c_kv @ w_up).reshape(B, T, nh, dn + dv)
    k_pe = k_pe[:, :, None, :].expand(B, T, nh, dr)
    return torch.cat([kv[..., :dn], k_pe], dim=-1), kv[..., dn:]


def mla_scale(cfg: ModelConfig) -> float:
    """Softmax scale of MLA: 1/√(nope + rope), in both forms."""
    a = cfg.attn
    return 1.0 / math.sqrt(a.qk_nope_head_dim + a.qk_rope_head_dim)


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

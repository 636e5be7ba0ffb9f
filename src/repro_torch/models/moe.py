"""Mixture-of-experts FFN on one rank (port of the reference
``models/moe.py`` at sequence-parallel size 1).

DeepSeek-style MoE [arXiv:2405.04434]: ``n_shared`` always-on experts
(fused into one SwiGLU of ``n_shared · d_expert``) plus ``n_routed`` routed
experts under a float32 softmax router with top-k gating, renormalised.

:func:`moe_apply` is the prefill / training form: capacity dispatch.  Each
expert takes at most ``cap = max(4, ceil(n · k · capacity_factor / E))``
of the ``n · k`` (token, choice) pairs, in token-major order (token 0's k
choices first, as ``jnp.repeat(h, k)`` orders them); a pair past its
expert's capacity is dropped (it adds nothing; the shared experts and the
residual carry the token).  The reference ships each expert's buffer to
its owner with two ``all_to_all``s; at one rank they are the identity.  It
also returns the load-balance auxiliary loss.

:func:`moe_decode_apply` is the decode / verify form, the reference's
design: every expert runs on every token and the outputs combine in
float32 with weights that are zero off the token's top k — no dispatch,
no capacity, no drops.

The expert products are batched matrix products (``torch.bmm``), computed
outside any attention kernel, as the reference computes them outside any
Pallas kernel.  Top-k breaks ties toward the lower expert index, as
``lax.top_k`` does (:func:`top_k`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.config import ModelConfig
from repro_torch.models.layers import rms_norm


def top_k(probs, k: int):
    """(values, indices) of the ``k`` largest entries of the last axis,
    largest first; equal values keep the lower index first (a stable
    descending sort), the order of ``lax.top_k``."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(cfg: ModelConfig, n: int) -> int:
    """Slots an expert takes when ``n`` tokens share one dispatch (the
    reference's float arithmetic)."""
    m = cfg.moe
    return int(max(4, -(-n * m.top_k * m.capacity_factor // m.n_routed)))


def _route(p, x, cfg: ModelConfig):
    """Normed rows h (n, d), float32 router probabilities (n, E), and the
    top-k (renormalised weights, experts), each (n, k)."""
    m = cfg.moe
    d = x.shape[-1]
    h = rms_norm(x, p["ln"], cfg.norm_eps).reshape(-1, d)
    probs = torch.softmax(h.float() @ p["router"], dim=-1)
    top_p, top_e = top_k(probs, m.top_k)
    return h, probs, top_p / top_p.sum(dim=-1, keepdim=True), top_e


def _expert_ffn(p, x):
    """SwiGLU of every expert on its rows: x (E, n, d) with weights
    (E, d, de) / (E, de, d)."""
    return torch.bmm(F.silu(torch.bmm(x, p["wg"])) * torch.bmm(x, p["wu"]),
                     p["wd"])


def _shared(p, h):
    return (F.silu(h @ p["sh_wg"]) * (h @ p["sh_wu"])) @ p["sh_wd"]


def moe_apply(p, x, cfg: ModelConfig):
    """Capacity-dispatched MoE layer with residual: x (b, t, d) →
    (x + y, aux), ``aux`` the float32 load-balance loss."""
    m = cfg.moe
    b, t, d = x.shape
    n, E, K = b * t, m.n_routed, m.top_k
    h, probs, top_p, top_e = _route(p, x, cfg)
    flat_e = top_e.reshape(-1)                               # (n·K,)
    counts = torch.zeros(E, dtype=torch.float32, device=x.device)
    counts.index_add_(0, flat_e, torch.ones_like(flat_e, dtype=torch.float32))
    f = counts / counts.sum().clamp(min=1.0)
    aux = E * (f * probs.mean(dim=0)).sum() * m.aux_loss_coef
    cap = capacity(cfg, n)
    onehot = F.one_hot(flat_e, E)
    pos = ((onehot.cumsum(dim=0) - 1) * onehot).sum(dim=-1)  # rank in expert
    keep = pos < cap
    slot = torch.where(keep, pos, torch.full_like(pos, cap))
    xk = h.repeat_interleave(K, dim=0)                       # (n·K, d)
    buf = h.new_zeros((E, cap + 1, d))
    buf[flat_e[keep], slot[keep]] = xk[keep]
    out = _expert_ffn(p, buf[:, :cap])                       # (E, cap, d)
    out = F.pad(out, (0, 0, 0, 1))                           # overflow → 0
    got = out[flat_e, slot]                                  # (n·K, d)
    got = got * (keep.to(got.dtype)
                 * top_p.reshape(-1).to(got.dtype))[:, None]
    y = got.reshape(n, K, d).sum(dim=1)
    if m.n_shared:
        y = y + _shared(p, h)
    return x + y.reshape(b, t, d).to(x.dtype), aux


def moe_decode_apply(p, x, cfg: ModelConfig):
    """Decode / verify MoE layer with residual, x (b, t, d): every expert on
    every row, combined in float32 with the top-k weights (zero
    elsewhere)."""
    m = cfg.moe
    b, t, d = x.shape
    h, _, top_p, top_e = _route(p, x, cfg)
    n = h.shape[0]
    w = torch.zeros((n, m.n_routed), dtype=torch.float32, device=x.device)
    w.scatter_(1, top_e, top_p)
    oe = _expert_ffn(p, h[None].expand(m.n_routed, n, d))    # (E, n, d)
    y = torch.einsum("ne,end->nd", w, oe.float())
    if m.n_shared:
        y = y + _shared(p, h).float()
    return x + y.reshape(b, t, d).to(x.dtype)

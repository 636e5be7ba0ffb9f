"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) with the
sequence-parallel cross-rank state relay (port of the reference
``models/ssm.py``).

The paper's attention scheduling does not apply to an attention-free SSM;
what carries over is the sequence-parallel decomposition: each rank of the
sequence group holds a contiguous shard of the tokens, runs the chunked SSD
algorithm on it, and the ranks combine their (small, d_state × head_dim a
head) recurrent states with a log₂(P)-step Hillis–Steele exclusive prefix
over ring shifts — the recurrent-scan analogue of the paper's ring.  The
depthwise causal conv takes its first ``d_conv - 1`` inputs (the halo) from
the previous rank.  Both travel through :func:`~repro_torch.parallel.comm.
shift`, whose backward is the opposite shift, so the relay and the halo
train.

Chunked SSD (exact, equal to the sequential recurrence):
  y_i  = Σ_{j≤i} (C_i·B_j) · exp(cum_i − cum_j) · dt_j · x_j   (intra-chunk)
       + C_i · exp(cum_i) · S_init                              (inter-chunk)
  S'   = exp(cum_L) · S_init + Σ_j exp(cum_L − cum_j) dt_j B_j ⊗ x_j

Everything inside the mixer runs in float32, as the reference's.  The
reference's ``lax.associative_scan`` over chunks becomes an exact prefix
over chunks in the same dual form as the intra-chunk part
(:func:`_chunk_prefix`: one lower-triangular matrix of cumulative chunk
decays a head, one product), so a layer launches a fixed number of kernels
whatever the number of chunks.  ``exp(cum_i − cum_j)`` above the diagonal
can overflow, and 0 · inf is NaN in the backward, so the differences are
masked with −inf *before* the exponential, in both places.  Each path
rounds as its reference counterpart does: the training conv adds one
product at a time in the model's dtype, the decode step's conv sums its
window's products at once (``jnp.sum`` and ``torch.sum`` both accumulate
bf16 in float32).  The plain PyTorch here is the whole port: the reference has no Pallas
kernel for the mixer.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.config import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.parallel.comm import shift as comm_shift


def ssm_params(cfg: ModelConfig, normal, dtype, device) -> dict:
    """One Mamba2 mixer's parameters, the reference's tree and init scheme:
    ``normal(shape, scale, dtype)`` draws N(0, scale²) (its bits differ
    from ``jax.random``'s); A = −exp(A_log) = −1, D = 1 and dt_bias = 0 in
    float32."""
    s, d = cfg.ssm, cfg.d_model
    di, nh = s.d_inner(d), s.n_heads(d)
    ch = di + 2 * s.d_state
    f32 = torch.float32
    return {
        "ln": torch.ones(d, dtype=dtype, device=device),
        "in_proj": normal((d, 2 * di + 2 * s.d_state + nh), 1 / math.sqrt(d),
                          dtype),
        "conv_w": normal((ch, s.d_conv), 0.2, dtype),
        "conv_b": torch.zeros(ch, dtype=dtype, device=device),
        "A_log": torch.zeros(nh, dtype=f32, device=device),
        "D": torch.ones(nh, dtype=f32, device=device),
        "dt_bias": torch.zeros(nh, dtype=f32, device=device),
        "gln": torch.ones(di, dtype=dtype, device=device),
        "out_proj": normal((di, d), 1 / math.sqrt(di), dtype),
    }


def _causal_conv(xbc, w, b, tail):
    """Depthwise causal conv.  xbc (b, t, ch); w (ch, k); tail (b, k − 1,
    ch): the previous shard's last inputs (zeros on the first).  w[:, k−1]
    multiplies the current token, w[:, 0] the oldest."""
    k = w.shape[1]
    xp = torch.cat([tail, xbc], dim=1)
    out = torch.zeros_like(xbc)
    for i in range(k):
        out = out + xp[:, i:i + xbc.shape[1]] * w[:, i][None, None, :]
    return out + b[None, None, :]


def _ssd_parts(x, B, C, dt, adt, chunk):
    """What the chunked SSD needs besides the carry-in: the intra-chunk
    output y (b, c, L, nh, hd), the chunks' total log-decays (b, c, nh) and
    states (b, c, nh, N, hd), the inclusive cumulative log-decays cum (b, c,
    L, nh) and C (b, c, L, N), all float32.  x (b, t, nh, hd); B, C (b, t,
    N); dt, adt (b, t, nh)."""
    b, t, nh, hd = x.shape
    N = B.shape[-1]
    L = min(chunk, t)
    if t % L:
        raise ValueError(f"{t} tokens do not split into chunks of {L}")
    c = t // L
    f32 = torch.float32
    xc = x.reshape(b, c, L, nh, hd).to(f32)
    Bc = B.reshape(b, c, L, N).to(f32)
    Cc = C.reshape(b, c, L, N).to(f32)
    dtc = dt.reshape(b, c, L, nh).to(f32)
    cum = adt.reshape(b, c, L, nh).to(f32).cumsum(dim=2)
    # intra-chunk (the dual, attention-like form); the masked differences
    # are −inf before the exponential (exp(+large) · 0 is NaN backward)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    dd = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (b,c,i,j,nh)
    dd = dd.masked_fill(~causal[None, None, :, :, None], float("-inf"))
    w = torch.exp(dd) * dtc[:, :, None, :, :]
    y = torch.einsum("bcijh,bcjhp->bcihp", scores[..., None] * w, xc)
    # chunk summaries
    wS = torch.exp(cum[:, :, -1:, :] - cum) * dtc           # (b, c, L, nh)
    S = torch.einsum("bcjn,bcjhp->bchnp", Bc, wS[..., None] * xc)
    return y, cum[:, :, -1, :], S, cum, Cc


def _chunk_prefix(log_decay, S, s_init):
    """The state entering each chunk (b, c, nh, N, hd) and the state after
    the last (b, nh, N, hd), from the carry-in s_init and the chunks' total
    log-decays (b, c, nh) and states: state i = Σ_{j<i} exp(ex_i −
    ex_{j+1}) S_j + exp(ex_i) s_init, ex_i the log-decay of chunks 0 .. i −
    1 (the reference's associative scan computes the same prefix).  The
    weights above the diagonal are masked before the exponential."""
    b, c, nh = log_decay.shape
    ex = F.pad(log_decay.cumsum(dim=1), (0, 0, 1, 0))       # (b, c + 1, nh)
    before = torch.ones(c + 1, c, dtype=torch.bool,
                        device=S.device).tril(diagonal=-1)
    diff = ex[:, :, None, :] - ex[:, None, 1:, :]           # (b, c+1, c, nh)
    diff = diff.masked_fill(~before[None, :, :, None], float("-inf"))
    states = torch.einsum("bijh,bjhnp->bihnp", torch.exp(diff), S) \
        + torch.exp(ex)[..., None, None] * s_init.to(torch.float32)[:, None]
    return states[:, :c], states[:, c]


def _ssd_finish(parts, s_init):
    """y (b, t, nh, hd) and the final state of :func:`_ssd_parts`' chunks
    carried in from s_init (b, nh, N, hd)."""
    y, log_decay, S, cum, Cc = parts
    s_prefix, s_last = _chunk_prefix(log_decay, S, s_init)
    y = y + torch.einsum("bcin,bcih,bchnp->bcihp", Cc, torch.exp(cum),
                         s_prefix)
    b, c, L, nh, hd = y.shape
    return y.reshape(b, c * L, nh, hd), s_last


def _ssd_chunked(x, B, C, dt, adt, s_init, chunk):
    """Exact chunked SSD (the reference's signature).  x (b, t, nh, hd);
    B, C (b, t, N); dt, adt (b, t, nh); s_init (b, nh, N, hd) the carry-in.
    Returns (y (b, t, nh, hd), s_out), float32."""
    return _ssd_finish(_ssd_parts(x, B, C, dt, adt, chunk), s_init)


def _device_prefix(group, decay, state):
    """Hillis–Steele exclusive prefix of (decay (b, nh), state (b, nh, N,
    hd)) over the ranks of ``group``: the state entering this rank's
    shard.  Monoid: segment 2 after segment 1 → (d1·d2, s1·d2 + s2).  Every
    rank takes part in every shift, and masks what it must not use by
    arithmetic rather than by branching, so the shifts' backwards (opposite
    shifts) run on every rank alike."""
    P, p = group.size, group.rank
    d_acc, s_acc = decay, state                     # inclusive running
    hop = 1
    while hop < P:
        d_in = comm_shift(group, d_acc, hop)
        s_in = comm_shift(group, s_acc, hop)
        valid = float(p >= hop)
        # the incoming (earlier) segment before ours
        s_acc = s_in * valid * d_acc[:, :, None, None] + s_acc
        d_acc = torch.where(torch.tensor(p >= hop, device=decay.device),
                            d_in * d_acc, d_acc)
        hop *= 2
    # exclusive = the inclusive of rank p − 1 (nothing on rank 0)
    s_ex = comm_shift(group, s_acc, 1)
    return torch.where(torch.tensor(p == 0, device=state.device),
                       torch.zeros_like(s_ex), s_ex)


def _halo(group, xbc, k):
    """The previous rank's last k − 1 conv inputs (zeros on rank 0)."""
    tail = comm_shift(group, xbc[:, -(k - 1):], 1)
    return torch.where(torch.tensor(group.rank == 0, device=xbc.device),
                       torch.zeros_like(tail), tail)


def _split(cfg: ModelConfig, zxbcdt):
    s = cfg.ssm
    di, N = s.d_inner(cfg.d_model), s.d_state
    return torch.split(zxbcdt, [di, di, N, N, zxbcdt.shape[-1] - 2 * di
                                - 2 * N], dim=-1)


def ssm_apply(p, x, cfg: ModelConfig, group=None):
    """One Mamba2 layer on this rank's shard x (b, t, d) of a sequence
    sharded over ``group`` (its ranks in sequence order; None or one rank:
    the whole sequence), residual included."""
    s = cfg.ssm
    b, t, d = x.shape
    di, nh, N = s.d_inner(d), s.n_heads(d), s.d_state
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    z, xin, B, C, dt = _split(cfg, h @ p["in_proj"])
    xbc = torch.cat([xin, B, C], dim=-1)
    k = s.d_conv
    P = 1 if group is None else group.size
    if P > 1:
        tail = _halo(group, xbc, k)
    else:
        tail = xbc.new_zeros((b, k - 1, xbc.shape[-1]))
    xbc = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"], tail))
    xin, B, C = torch.split(xbc, [di, N, N], dim=-1)
    dtf = F.softplus(dt.float() + p["dt_bias"])
    adt = -torch.exp(p["A_log"]) * dtf                      # (b, t, nh)
    xh = xin.reshape(b, t, nh, -1)
    parts = _ssd_parts(xh, B, C, dtf, adt, s.chunk)
    s_init = torch.zeros((b, nh, N, di // nh), dtype=torch.float32,
                         device=x.device)
    if P > 1:       # the shard's own total, then the relay's carry-in
        _, s_total = _chunk_prefix(parts[1], parts[2], s_init)
        s_init = _device_prefix(group, torch.exp(adt.sum(dim=1)), s_total)
    y, _ = _ssd_finish(parts, s_init)
    y = y + p["D"][None, None, :, None] * xh.float()
    y = y.reshape(b, t, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["gln"], cfg.norm_eps)
    return x + (y @ p["out_proj"]).to(x.dtype)


# ----------------------------------------------------------------- decode

def ssm_decode_step(p, x, state, conv_tail, cfg: ModelConfig):
    """One-token recurrent update.  x (b, 1, d); state (b, nh, N, hd)
    float32; conv_tail (b, k − 1, ch).  Returns (y, state', conv_tail')."""
    s = cfg.ssm
    b, _, d = x.shape
    di, nh, N = s.d_inner(d), s.n_heads(d), s.d_state
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    z, xin, B, C, dt = _split(cfg, h @ p["in_proj"])
    xbc = torch.cat([xin, B, C], dim=-1)                    # (b, 1, ch)
    window = torch.cat([conv_tail, xbc], dim=1)             # (b, k, ch)
    conv = (window * p["conv_w"].T[None]).sum(dim=1) + p["conv_b"]
    xin1, B1, C1 = torch.split(F.silu(conv), [di, N, N], dim=-1)
    dtf = F.softplus(dt[:, 0].float() + p["dt_bias"])
    dec = torch.exp(-torch.exp(p["A_log"]) * dtf)           # (b, nh)
    xh = xin1.reshape(b, nh, -1).float()
    state = state * dec[:, :, None, None] + torch.einsum(
        "bn,bh,bhp->bhnp", B1.float(), dtf, xh)
    y = torch.einsum("bn,bhnp->bhp", C1.float(), state)
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(b, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["gln"], cfg.norm_eps)
    return x + (y @ p["out_proj"]).to(x.dtype), state, window[:, 1:]


# ------------------------------------------------------------ test oracle

def ssm_sequential_ref(p, x, cfg: ModelConfig):
    """Token-by-token recurrence (one rank; the tests' oracle)."""
    s = cfg.ssm
    b, t, d = x.shape
    di, nh, N = s.d_inner(d), s.n_heads(d), s.d_state
    state = torch.zeros((b, nh, N, di // nh), dtype=torch.float32,
                        device=x.device)
    tail = x.new_zeros((b, s.d_conv - 1, di + 2 * N))
    outs = []
    for i in range(t):
        y, state, tail = ssm_decode_step(p, x[:, i:i + 1], state, tail, cfg)
        outs.append(y)
    return torch.cat(outs, dim=1)

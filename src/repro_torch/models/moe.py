"""Mixture-of-experts FFN with expert parallelism over the sequence axis
(port of the reference ``models/moe.py``).

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

Across S ranks of the sequence group (the ``model`` axis, whose ranks
already hold distinct tokens) each rank holds ``E / S`` of the routed
experts — rows ``[r·E/S, (r+1)·E/S)`` of ``wg`` / ``wu`` / ``wd`` — and
every other leaf whole, as the reference's ``pspec``.  Under FSDP
(``parallel/fsdp.py``) the expert leaves shard two ways: their rows over
the sequence axis, as here, and the dim the reference's ``param_spec``
picks next (the largest the FSDP size divides) over ``pod`` × ``data``;
the layer gathers that dim before it calls :func:`moe_apply`, which sees
this rank's rows whole.  The capacity comes
from this rank's rows; the ``(E, cap, d)`` buffer goes to the experts'
owners by an ``all_to_all`` and comes back by a second one; the expert
counts are summed and the mean probabilities averaged over the ranks
holding distinct tokens (``all_group``), so ``aux`` is the global value
on every rank.  Every rank issues the same collectives in the same order,
kept pairs or not.

On a 2D (seq = r) × (head = u) mesh the reference's ``shard_map`` over
``P(b, seq_axis, None)`` holds a seq shard's T/r rows whole on each of its
u head ranks, so the routed experts shard over ``seq`` alone (E/r a rank,
the same on the u head ranks), the capacity comes from T/r rows and the
aux statistics reduce over the batch and ``seq`` axes, not ``head``.
Here (``rows``, the head Comm) each rank gathers its seq shard's rows over
``head`` (:func:`~repro_torch.parallel.comm.gather_rows`), dispatches them
all and keeps its own piece of the output.  The u head ranks compute the
same thing; each carries the gradient of its own rows only — of the
output (the gather's backward keeps this rank's piece) and of the aux
loss's mean probabilities (the other pieces' rows enter detached) — so the
train step's sums over the ranks count every row once: the replicated
leaves over every rank, the expert shards over ``head``.

:func:`moe_decode_apply` is the decode / verify form, the reference's
design: every expert runs on every token and the outputs combine in
float32 with weights that are zero off the token's top k — no dispatch,
no capacity, no drops.  Across ranks each rank runs its local experts on
every row and the float32 sums are all-reduced over the sequence group.

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
from repro_torch.parallel.comm import all_reduce, all_to_all, gather_rows


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


def local_experts(cfg: ModelConfig, S: int) -> int:
    """Routed experts a rank holds when ``S`` ranks share them."""
    E = cfg.moe.n_routed
    if E % S:
        raise ValueError(f"{E} routed experts do not shard over {S} ranks")
    return E // S


def dispatch_slots(flat_e, E: int, cap: int):
    """(slot, keep) of each (token, choice) pair ``flat_e`` (n·K,): its
    rank among the earlier pairs routed to the same expert, and whether
    that rank is below ``cap``; a dropped pair's slot is ``cap`` (the
    overflow row)."""
    # one-hot by comparison (F.one_hot checks its input's range on the
    # host: a device sync, and no such check on the meta device)
    onehot = (flat_e[:, None] == torch.arange(E, device=flat_e.device)).long()
    pos = ((onehot.cumsum(dim=0) - 1) * onehot).sum(dim=-1)  # rank in expert
    keep = pos < cap
    return torch.where(keep, pos, torch.full_like(pos, cap)), keep


def _size(group) -> int:
    return 1 if group is None else group.size


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


def moe_apply(p, x, cfg: ModelConfig, *, group=None, all_group=None,
              rows=None):
    """Capacity-dispatched MoE layer with residual: x (b, t, d) →
    (x + y, aux), ``aux`` the float32 load-balance loss.  ``group`` is the
    sequence axis's Comm over which the routed experts shard (None: one
    rank, every expert here); ``all_group`` the ranks holding distinct
    rows (the data and sequence axes), over which the expert counts are
    summed and the mean probabilities averaged; ``rows`` a 2D mesh's head
    Comm, whose ranks hold the pieces of one seq shard's rows (module
    docstring): the dispatch runs over the gathered rows and this rank's
    piece of the output comes back."""
    if rows is None or rows.size == 1:
        return _moe_apply(p, x, cfg, group, all_group)
    t = x.shape[1]
    xs = gather_rows(rows, x, dim=1)
    own = torch.zeros(xs.shape[:2], dtype=torch.bool, device=x.device)
    own[:, rows.rank * t:(rows.rank + 1) * t] = True
    y, aux = _moe_apply(p, xs, cfg, group, all_group, own.reshape(-1))
    return y[:, rows.rank * t:(rows.rank + 1) * t], aux


def _moe_apply(p, x, cfg, group, all_group, own=None):
    """:func:`moe_apply` over the rows of ``x``; ``own`` (n,) marks the
    rows whose probabilities carry the aux loss's gradient (None: all)."""
    m = cfg.moe
    b, t, d = x.shape
    n, E, K = b * t, m.n_routed, m.top_k
    S = _size(group)
    e_loc = local_experts(cfg, S)
    h, probs, top_p, top_e = _route(p, x, cfg)
    flat_e = top_e.reshape(-1)                               # (n·K,)
    counts = torch.zeros(E, dtype=torch.float32, device=x.device)
    counts.index_add_(0, flat_e, torch.ones_like(flat_e, dtype=torch.float32))
    if own is not None:
        probs = torch.where(own[:, None], probs, probs.detach())
    pm = probs.mean(dim=0)
    if _size(all_group) > 1:
        all_group.all_reduce_([counts])
        pm = all_reduce(all_group, pm, "mean")
    f = counts / counts.sum().clamp(min=1.0)
    aux = E * (f * pm).sum() * m.aux_loss_coef
    cap = capacity(cfg, n)
    slot, keep = dispatch_slots(flat_e, E, cap)
    xk = h.repeat_interleave(K, dim=0)                       # (n·K, d)
    buf = h.new_zeros((E, cap + 1, d))
    # every pair writes: a kept one its own slot, a dropped one the
    # overflow row, cut off below (no boolean index: no host sync, and the
    # shapes do not depend on the routing)
    buf[flat_e, slot] = xk
    buf = buf[:, :cap]
    if S > 1:                        # each expert's rows to its owner
        buf = all_to_all(group, buf.reshape(S, e_loc * cap, d), 0, 0)
        buf = buf.reshape(S, e_loc, cap, d).transpose(0, 1) \
                 .reshape(e_loc, S * cap, d)
    out = _expert_ffn(p, buf)                                # local experts
    if S > 1:                        # and the results back
        out = out.reshape(e_loc, S, cap, d).transpose(0, 1) \
                 .reshape(S, e_loc * cap, d)
        out = all_to_all(group, out, 0, 0).reshape(E, cap, d)
    out = F.pad(out, (0, 0, 0, 1))                           # overflow → 0
    got = out[flat_e, slot]                                  # (n·K, d)
    got = got * (keep.to(got.dtype)
                 * top_p.reshape(-1).to(got.dtype))[:, None]
    y = got.reshape(n, K, d).sum(dim=1)
    if m.n_shared:
        y = y + _shared(p, h)
    return x + y.reshape(b, t, d).to(x.dtype), aux


def moe_decode_apply(p, x, cfg: ModelConfig, *, group=None):
    """Decode / verify MoE layer with residual, x (b, t, d): every expert on
    every row, combined in float32 with the top-k weights (zero
    elsewhere).  Across the ranks of ``group`` (the sequence axis; the
    rows are the same on each) a rank runs its own experts and the float32
    sums are all-reduced."""
    m = cfg.moe
    b, t, d = x.shape
    S = _size(group)
    e_loc = local_experts(cfg, S)
    lo = 0 if group is None else group.rank * e_loc
    h, _, top_p, top_e = _route(p, x, cfg)
    n = h.shape[0]
    w = torch.zeros((n, m.n_routed), dtype=torch.float32, device=x.device)
    w.scatter_(1, top_e, top_p)
    oe = _expert_ffn(p, h[None].expand(e_loc, n, d))         # (e_loc, n, d)
    y = torch.einsum("ne,end->nd", w[:, lo:lo + e_loc], oe.float())
    if S > 1:
        group.all_reduce_([y])
    if m.n_shared:
        y = y + _shared(p, h).float()
    return x + y.reshape(b, t, d).to(x.dtype)

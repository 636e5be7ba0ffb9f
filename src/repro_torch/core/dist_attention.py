"""DISTFLASHATTN entry points (port of the reference
``core/dist_attention.py``, without the 2D seq×head plans, sequence-sharded
decode and the MLA latent ring).

Sequence-parallel exact attention over a group of ``P`` ranks (the paper's
workers), each a ``torch.distributed`` process holding its contiguous
shard of the sequence (zigzag: its two mirror chunks).  Schedules
(validated in ``DistAttnSpec.__post_init__``: a typo raises):

* ``balanced`` — the paper's load-balanced schedule (§3.2, Alg. 2): ⌊P/2⌋
  ring steps; workers with causal work left compute ``attn(q_p, kv_{p−t})``
  while helpers compute ``attn(q_{(h−t) mod P}, kv_h)`` for them and ship
  the partial ``(o, lse)`` home.  Causal-kind masks.
* ``ring`` — vanilla DISTFLASHATTN (§3.1, Alg. 1): P−1 steps, workers idle
  once their causal prefix is done.  Also bidirectional masks.
* ``zigzag`` — 2P half-chunks, rank p holds (p, 2P−1−p): balance with only
  the KV ring.  Contract: global arrays are permuted with
  :func:`zigzag_perm` before sharding.
* ``ulysses`` — the DeepSpeed-Ulysses head-parallel baseline (all-to-all);
  raises on head counts not divisible by P (paper §4.2/§4.6).
* ``rsa`` — the Ring Self-Attention baseline: all-gathers K and V and
  materializes the full score matrix.  Forward only; benchmark baseline.
* ``auto`` — at P = 1 every schedule is the local kernel; at P > 1 it
  needs the cost model's H100 constants and tune table, which the port does
  not have yet, and raises ``NotImplementedError``.

The ring-family schedules are plans (:mod:`repro_torch.core.schedule`)
run by one forward and one backward executor; every plan step launches
kernel A forward and kernels C and D backward with its own static mask.
The baselines' backward is the ring plan's, with the reference's refusals.
At ``axis_size == 1`` every schedule reduces to the local chunk kernels, as
the reference's ``_fwd_local`` / ``_bwd_local`` do.

The backward is exposed on its own so that the rematerialization-aware
checkpointing (``core/remat.py``) can call it from the saved ``(o, lse)``
without rerunning the forward or its communication (§3.3).
:func:`dist_flash_attn` is the differentiable op for the other policies.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import mask as mk
from repro_torch.core import schedule as sp
from repro_torch.core.attention import chunk_attn, chunk_attn_bwd
from repro_torch.core.mask import MaskSpec
from repro_torch.kernels.flash_attention import FlashAttnFn
from repro_torch.kernels.ref import NEG_INF

SCHEDULES = ("auto", "balanced", "ring", "rsa", "ulysses", "zigzag")

_MASK_HINT = ("mask=repro_torch.core.mask.{full,causal,sliding_window,"
              "prefix_lm,document}(...)")


@dataclasses.dataclass(frozen=True)
class DistAttnSpec:
    """Static description of one distributed-attention call site.

    ``axis`` names the sequence-parallel mesh axis and ``axis_size`` is its
    number of ranks P; the call takes that axis's group
    (:class:`~repro_torch.parallel.comm.Comm`).  ``schedule`` ∈
    :data:`SCHEDULES`.  ``mask`` is the MaskSpec of the whole (unsharded)
    attention and must be offset-free; it defaults to causal.  The removed
    ``causal=`` / ``window=`` kwargs raise ``TypeError``.  The
    mask/schedule checks for ``axis_size > 1`` are the reference's, so a
    spec the reference refuses is refused here too.
    """
    axis: str = "model"
    axis_size: int = 1
    schedule: str = "balanced"
    mask: Optional[MaskSpec] = None
    causal: dataclasses.InitVar[Optional[bool]] = None
    window: dataclasses.InitVar[Optional[int]] = None
    scale: Optional[float] = None
    impl: Optional[object] = None   # a registry name, or a Backend

    def __post_init__(self, causal, window):
        if causal is not None or window is not None:
            raise TypeError("DistAttnSpec(causal=, window=) was removed; "
                            "pass " + _MASK_HINT)
        if self.schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {self.schedule!r}; valid: "
                             f"{SCHEDULES}")
        if self.mask is None:
            object.__setattr__(self, "mask", mk.causal())
        m = self.mask
        if m.q_offset or m.kv_offset:
            raise ValueError("DistAttnSpec.mask must be offset-free — the "
                             "schedules derive per-step offsets")
        if self.axis_size > 1:
            if self.schedule in ("balanced", "zigzag") and \
                    not (m.causal and not m.prefix_len):
                raise ValueError(f"{self.schedule!r} handles causal-kind "
                                 f"masks only (got {m.kind!r}); use "
                                 f"ring/ulysses")
            if m.prefix_len and self.schedule == "ring":
                raise ValueError(
                    "prefix_lm needs absolute kv positions, which the ring "
                    "schedule's per-shard chunks don't have; use "
                    "ulysses/rsa or a single-shard axis")
            if m.window and self.schedule == "rsa":
                raise ValueError("rsa baseline has no sliding-window path")
            if m.window and not m.causal and self.schedule == "ring":
                raise ValueError(
                    "a non-causal sliding window needs future-direction "
                    "band steps the ring's strictly-past step masks can't "
                    "express; use ulysses or a single-shard axis")


def _tune(spec: DistAttnSpec) -> dict:
    """Chunk-kernel keyword arguments carried by the spec."""
    return dict(scale=spec.scale, impl=spec.impl)


def _seg_kw(mask: MaskSpec, segments) -> dict:
    """Segment operands, only when the mask consumes them."""
    if not mask.document or segments is None:
        return {}
    return dict(q_segments=segments, kv_segments=segments)


def _comm(spec: DistAttnSpec, group):
    if group is None or group.size != spec.axis_size:
        raise ValueError(
            f"axis_size={spec.axis_size} needs the group of mesh axis "
            f"{spec.axis!r} with that many ranks, got "
            f"{None if group is None else group.size}")
    return group


def resolve_schedule(spec: DistAttnSpec) -> str:
    """The concrete schedule of a call at ``axis_size > 1``."""
    if spec.schedule != "auto":
        return spec.schedule
    raise NotImplementedError(
        "schedule='auto' at axis_size > 1 ranks the candidates with the "
        "plan cost model's roofline constants and the tune/ table, which "
        "the port does not have for the H100 yet (ROADMAP §1 item 10: "
        "tune/ and analysis/roofline.py); name a schedule")


# --------------------------------------------------------------------------
# Bespoke baselines (not plan-based: different communication topology)
# --------------------------------------------------------------------------

def _fwd_ulysses(spec, comm, q, k, v, seg=None):
    """DeepSpeed-Ulysses baseline: all-to-all the sequence-sharded q/k/v
    into a head-sharded layout, run the local kernel over the whole
    sequence, all-to-all back.  Head counts must divide by P — the
    limitation the paper targets (§4.2, §4.6)."""
    P = spec.axis_size
    Hq, Hkv = q.shape[2], k.shape[2]
    if Hq % P or Hkv % P:
        raise ValueError(
            f"ulysses needs heads % P == 0 (got Hq={Hq}, Hkv={Hkv}, P={P})"
            " — the head-divisibility limitation of head-parallel attention")
    qh, kh, vh = (comm.all_to_all(x, split_dim=2, concat_dim=1)
                  for x in (q, k, v))                # (B, T, H/P, D)
    m = spec.mask
    skw = {}
    if seg is not None and m.document:
        seg_g = comm.all_gather(seg, dim=1)
        skw = dict(q_segments=seg_g, kv_segments=seg_g)
    o, s = chunk_attn(qh, kh, vh, mask=m, **skw, **_tune(spec))
    return (comm.all_to_all(o, split_dim=1, concat_dim=2),
            comm.all_to_all(s, split_dim=1, concat_dim=2))


def _fwd_rsa(spec, comm, q, k, v, seg=None):
    """Ring Self-Attention baseline: all-gather KV, materialize scores."""
    m = spec.mask
    if m.needs_segments and seg is None:
        raise ValueError("document mask without boundaries needs segments=")
    kg = comm.all_gather(k, dim=1)
    vg = comm.all_gather(v, dim=1)
    B, Tq, Hq, D = q.shape
    g = Hq // kg.shape[2]
    scale = spec.scale or 1.0 / (D ** 0.5)
    kf = kg.float().repeat_interleave(g, dim=2) if g > 1 else kg.float()
    vf = vg.float().repeat_interleave(g, dim=2) if g > 1 else vg.float()
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    if m.needs_mask:
        qpos = comm.rank * Tq + torch.arange(Tq, device=q.device)
        kpos = torch.arange(kg.shape[1], device=q.device)
        qs = ks = None
        if m.document and seg is not None:
            sg = comm.all_gather(seg, dim=1)
            qs, ks = seg[:, :, None], sg[:, None, :]
        allow = m.allow(qpos[:, None], kpos[None, :], qs, ks)
        allow = allow[None, None] if allow.ndim == 2 else allow[:, None]
        sc = torch.where(allow, sc, torch.full_like(sc, NEG_INF))
    w = torch.softmax(sc, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", w, vf)
    lse = torch.logsumexp(sc, dim=-1).transpose(1, 2).contiguous()
    return o.to(q.dtype), lse


# --------------------------------------------------------------------------
# Public API
# --------------------------------------------------------------------------

def dist_attn_fwd(q, k, v, *, spec: DistAttnSpec, group=None,
                  segments=None):
    """Forward → (o, lse) of this rank's shard.  q (B,Tl,Hq,D), k/v
    (B,Tl,Hkv,D); ``group`` is the sequence axis's
    :class:`~repro_torch.parallel.comm.Comm` (unused at ``axis_size ==
    1``); ``segments`` (B, Tl) document ids (document masks only)."""
    if spec.axis_size == 1:
        return chunk_attn(q, k, v, mask=spec.mask, **_tune(spec),
                          **_seg_kw(spec.mask, segments))
    comm = _comm(spec, group)
    sched = resolve_schedule(spec)
    if sched == "rsa":
        return _fwd_rsa(spec, comm, q, k, v, segments)
    if sched == "ulysses":
        return _fwd_ulysses(spec, comm, q, k, v, segments)
    plan = sp.build_plan(sched, spec.mask, spec.axis_size, q.shape[1])
    return sp.execute_fwd(plan, q, k, v, segments, comm=comm,
                          tune=_tune(spec))


def dist_attn_bwd(q, k, v, o, lse, do, *, spec: DistAttnSpec, group=None,
                  segments=None):
    """Backward from the saved (o, lse) → (dq, dk, dv) of this rank's
    shard."""
    if spec.axis_size == 1:
        return chunk_attn_bwd(q, k, v, o, lse, do, mask=spec.mask,
                              **_tune(spec), **_seg_kw(spec.mask, segments))
    comm = _comm(spec, group)
    sched = resolve_schedule(spec)
    if sched in ("rsa", "ulysses"):
        # the baselines reuse the exact ring backward, which cannot express
        # absolute coordinates (prefix masks) in its per-shard chunks
        if spec.mask.prefix_len:
            raise ValueError("prefix_lm distributed backward needs "
                             "axis_size == 1 (fwd-only baselines "
                             "support it)")
        if spec.mask.window and not spec.mask.causal:
            raise ValueError("non-causal sliding-window distributed "
                             "backward needs axis_size == 1 (the ring "
                             "backward the baselines reuse can't see "
                             "future-direction bands)")
        sched = "ring"
    plan = sp.build_plan(sched, spec.mask, spec.axis_size, q.shape[1])
    return sp.execute_bwd(plan, q, k, v, o, lse, do, segments, comm=comm,
                          tune=_tune(spec))


def dist_flash_attn(q, k, v, spec: DistAttnSpec, group=None, segments=None):
    """DISTFLASHATTN with autograd: (o, lse), whose backward is
    :func:`dist_attn_bwd` from the saved (o, lse).  lse is a residual
    output (its gradient is ignored); ``segments`` is not
    differentiable."""
    return FlashAttnFn.apply(
        q, k, v,
        lambda q, k, v: dist_attn_fwd(q, k, v, spec=spec, group=group,
                                      segments=segments),
        lambda q, k, v, o, lse, do: dist_attn_bwd(
            q, k, v, o, lse, do, spec=spec, group=group, segments=segments))


def zigzag_perm(T: int, P: int) -> np.ndarray:
    """Natural → zigzag permutation: the global array order
    [chunk 0, chunk 2P−1 | chunk 1, chunk 2P−2 | …], so contiguous rank
    shards hold (p, 2P−1−p).  An index array of length T."""
    c = T // (2 * P)
    order = []
    for p in range(P):
        order.append(np.arange(p * c, (p + 1) * c))
        q = 2 * P - 1 - p
        order.append(np.arange(q * c, (q + 1) * c))
    return np.concatenate(order)


def shard_positions(T: int, P: int, p: int, zigzag: bool = False):
    """Global token positions held by rank ``p`` of ``P`` on a sequence of
    ``T``: ``p·Tl + arange(Tl)``, or rank p's slice of :func:`zigzag_perm`
    under the zigzag layout."""
    Tl = T // P
    if zigzag and P > 1:
        return zigzag_perm(T, P)[p * Tl:(p + 1) * Tl]
    return np.arange(p * Tl, (p + 1) * Tl)

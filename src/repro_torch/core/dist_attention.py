"""DISTFLASHATTN entry points (port of the reference
``core/dist_attention.py``).

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
* ``auto`` — at P = 1 every schedule is the local kernel; at P > 1 the
  cheapest capable one by ``core/schedule.choose_schedule`` (a tuning
  table's measured row, its calibrated coefficients, or the roofline at
  the H100's constants, ``analysis/roofline.py``), on a 2D spec the
  cheapest inner schedule (``choose_inner_schedule``):
  :func:`resolve_schedule`.

The ring-family schedules are plans (:mod:`repro_torch.core.schedule`)
run by one forward and one backward executor; every plan step launches
kernel A forward and kernels C and D backward with its own static mask.

``DistAttnSpec.mesh2d`` (:class:`Mesh2DSpec`) factors the P ranks into a
(seq = r) × (head = u) grid: the sequence is sharded over the pair (seq
major, head minor), a head all-to-all over ``head`` gives each rank a
contiguous T/r shard of Hq/u query heads, the ring-family plan runs over
``seq``, and the inverse all-to-all brings the results home
(``schedule.execute2d_fwd`` / ``execute2d_bwd``).  Such a call takes the
two groups, ``group=(seq, head)``.
The baselines' backward is the ring plan's, with the reference's refusals.
At ``axis_size == 1`` every schedule reduces to the local chunk kernels, as
the reference's ``_fwd_local`` / ``_bwd_local`` do.

:func:`dist_attn_fwd_latent` is the MLA latent ring (beyond the paper): the
zigzag plan run with each rank's latent rows (kv_lora + rope, 576 a
position for deepseek-v2-lite-16b) on the KV ring in place of its
materialised K/V (16 × (192 + 128) = 5,120), every rank up-projecting what
arrives — recompute over communication.

:func:`dist_decode_attn` is decode against a KV cache sharded along the
sequence (flash-decoding across ranks), the serving side of long context.

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
class Mesh2DSpec:
    """The factored 2D (sequence × head) axis pair of one call: the
    ``axis_size = r·u`` sequence-parallel ranks form an (``seq_axis`` = r)
    × (``head_axis`` = u) grid; the sequence is sharded over the pair, seq
    major, head minor."""
    r: int
    u: int
    seq_axis: str = "seq"
    head_axis: str = "head"

    def __post_init__(self):
        if self.r < 1 or self.u < 1:
            raise ValueError(f"Mesh2DSpec needs r, u >= 1 "
                             f"(got r={self.r}, u={self.u})")
        if self.seq_axis == self.head_axis:
            raise ValueError("Mesh2DSpec seq_axis and head_axis must be "
                             "distinct mesh axes")


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

    ``mesh2d`` factors the ``axis_size`` ranks into a (seq = r, head = u)
    grid (:class:`Mesh2DSpec`); the ring-family schedules then run on the
    seq sub-axis after a head scatter on the head sub-axis, and the mask
    checks follow the seq sub-axis: at r == 1 the inner plan is one local
    full-sequence kernel, so any mask goes.
    """
    axis: str = "model"
    axis_size: int = 1
    schedule: str = "balanced"
    mask: Optional[MaskSpec] = None
    causal: dataclasses.InitVar[Optional[bool]] = None
    window: dataclasses.InitVar[Optional[int]] = None
    scale: Optional[float] = None
    impl: Optional[object] = None   # a registry name, or a Backend
    mesh2d: Optional[Mesh2DSpec] = None

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
        ring_P = self.axis_size
        if self.mesh2d is not None:
            md = self.mesh2d
            if md.r * md.u != self.axis_size:
                raise ValueError(f"mesh2d r·u = {md.r * md.u} must equal "
                                 f"axis_size = {self.axis_size}")
            if self.schedule not in ("auto",) + sp.PLAN_SCHEDULES:
                raise ValueError(
                    f"2D (seq×head) attention runs ring-family plans only "
                    f"(got {self.schedule!r}); the ulysses/rsa baselines "
                    f"have their own 1D topology")
            ring_P = md.r
        if ring_P > 1:
            if self.schedule in sp.PLAN_SCHEDULES and \
                    not sp.plan_capable(self.schedule, m):
                raise ValueError(_incapable(self.schedule, m))
            if m.window and self.schedule == "rsa":
                raise ValueError("rsa baseline has no sliding-window path")


def _incapable(schedule: str, m: MaskSpec) -> str:
    """Why a plan schedule cannot serve mask ``m`` on more than one
    shard (``schedule.plan_capable`` is false)."""
    if schedule in ("balanced", "zigzag") and not (m.causal
                                                   and not m.prefix_len):
        return (f"{schedule!r} handles causal-kind masks only (got "
                f"{m.kind!r}); use ring/ulysses")
    if m.prefix_len:
        return ("prefix_lm needs absolute kv positions, which the ring "
                "schedule's per-shard chunks don't have; use ulysses/rsa, "
                "a 2D mesh with r == 1, or a single-shard axis")
    return ("a non-causal sliding window needs future-direction band steps "
            "the ring's strictly-past step masks can't express; use "
            "ulysses, a 2D mesh with r == 1, or a single-shard axis")


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


def _comms2d(spec: DistAttnSpec, group):
    """The (seq, head) Comms of a 2D call, ``group``."""
    md = spec.mesh2d
    if not isinstance(group, (tuple, list)) or len(group) != 2:
        raise ValueError(
            f"a 2D spec (r={md.r}, u={md.u}) needs the groups of mesh axes "
            f"{md.seq_axis!r} and {md.head_axis!r}: group=(seq, head), got "
            f"{type(group).__name__}")
    seq, head = group
    if seq.size != md.r or head.size != md.u:
        raise ValueError(f"a 2D spec (r={md.r}, u={md.u}) on groups of "
                         f"{seq.size} and {head.size} ranks")
    return seq, head


def resolve_schedule(spec: DistAttnSpec, q, k, v, seg=None, *,
                     for_bwd: bool = False) -> str:
    """The concrete schedule of a call at ``axis_size > 1``.  ``auto``
    ranks the capable candidates by ``core/schedule``'s cost model (a
    tuning table's measured row first, then its calibrated coefficients,
    then the roofline at ``analysis/roofline``'s H100 constants);
    ``for_bwd`` says the choice must also serve the distributed backward
    (the baselines, whose backward is the ring plan's, drop out where it
    would raise) and ranks by forward and backward together.  On a 2D spec
    the grid is fixed and only the inner seq-axis schedule is chosen.
    The shapes are the same on every rank, so every rank resolves the same
    name."""
    if spec.schedule != "auto":
        return spec.schedule
    kw = dict(B=q.shape[0], Hq=q.shape[2], Hkv=k.shape[2], Dqk=q.shape[3],
              Dv=v.shape[3], bpe=q.dtype.itemsize,
              dynamic_seg=seg is not None, include_bwd=for_bwd)
    if spec.mesh2d is not None:
        return sp.choose_inner_schedule(spec.mask, spec.mesh2d.r,
                                        spec.mesh2d.u, Tl_dev=q.shape[1],
                                        **kw)
    return sp.choose_schedule(spec.mask, spec.axis_size, Tl=q.shape[1],
                              **kw)


def _plan2d(spec: DistAttnSpec, sched: str, q, k):
    """The 2D plan of a call; at r == 1 every ring-family schedule is the
    same local full-sequence kernel, so it builds as ``ring``."""
    md = spec.mesh2d
    sched = "ring" if md.r == 1 else sched
    return sp.build_plan2d(sched, spec.mask, md.r, md.u, q.shape[1],
                           Hq=q.shape[2], Hkv=k.shape[2])


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
                  segments=None, for_bwd: bool = False):
    """Forward → (o, lse) of this rank's shard.  q (B,Tl,Hq,D), k/v
    (B,Tl,Hkv,D); ``group`` is the sequence axis's
    :class:`~repro_torch.parallel.comm.Comm` (unused at ``axis_size ==
    1``), or for a 2D spec the ``(seq, head)`` pair of Comms;
    ``segments`` (B, Tl) document ids (document masks only).
    ``for_bwd``: :func:`dist_attn_bwd` will run from this forward's
    (o, lse), so ``auto`` resolves with the backward's horizon and both
    run the same schedule (:func:`resolve_schedule`)."""
    if spec.axis_size == 1:
        return chunk_attn(q, k, v, mask=spec.mask, **_tune(spec),
                          **_seg_kw(spec.mask, segments))
    if spec.mesh2d is not None:
        sched = resolve_schedule(spec, q, k, v, segments, for_bwd=for_bwd)
        seq, head = _comms2d(spec, group)
        if spec.mesh2d.u == 1:      # degenerate: the plain 1D seq plan
            plan = sp.build_plan(sched, spec.mask, spec.mesh2d.r,
                                 q.shape[1])
            return sp.execute_fwd(plan, q, k, v, segments, comm=seq,
                                  tune=_tune(spec))
        return sp.execute2d_fwd(_plan2d(spec, sched, q, k), q, k, v,
                                segments, seq=seq, head=head,
                                tune=_tune(spec))
    comm = _comm(spec, group)
    sched = resolve_schedule(spec, q, k, v, segments, for_bwd=for_bwd)
    if sched == "rsa":
        return _fwd_rsa(spec, comm, q, k, v, segments)
    if sched == "ulysses":
        return _fwd_ulysses(spec, comm, q, k, v, segments)
    plan = sp.build_plan(sched, spec.mask, spec.axis_size, q.shape[1])
    return sp.execute_fwd(plan, q, k, v, segments, comm=comm,
                          tune=_tune(spec))


FAULT_37 = (
    "the latent ring on a 2D mesh with u > 1: the reference's "
    "dist_attn_fwd_latent builds the zigzag plan for r·u ranks but "
    "shard_maps it over the seq axis alone (r ranks), and its ppermute "
    "refuses the permutation (ROADMAP fault 3.7); serve with "
    "latent_ring=False, balanced or ring")


def dist_attn_fwd_latent(q, k, v, payload, w_up, expand, *,
                         spec: DistAttnSpec, group=None):
    """Latent-ring forward → (o, lse) of this rank's shard, under the
    zigzag plan (the ranks hold the zigzag layout).  q, k, v (B, Tl, H, ·)
    are this rank's materialised projections; ``payload`` (B, Tl, d_lat)
    the latent rows they come from, which travel on the KV ring instead of
    (k, v); ``w_up`` the up-projection, the same on every rank; ``expand(
    payload, w_up) -> (k, v)`` (``layers.mla_expand``) rebuilds them on
    arrival.  Plain causal masks only, as the reference; a 2D spec raises
    (:data:`FAULT_37`)."""
    if spec.mask.kinds - {"causal"}:
        raise ValueError("latent ring supports plain causal masks only "
                         f"(got {spec.mask.kind!r})")
    if spec.mesh2d is not None:
        raise ValueError(FAULT_37)
    if spec.axis_size == 1:
        return chunk_attn(q, k, v, mask=spec.mask, **_tune(spec))
    plan = sp.build_plan("zigzag", spec.mask, spec.axis_size, q.shape[1])
    return sp.execute_fwd(plan, q, k, v, None, comm=_comm(spec, group),
                          tune=_tune(spec), latent=(payload, w_up, expand))


def dist_attn_bwd(q, k, v, o, lse, do, *, spec: DistAttnSpec, group=None,
                  segments=None):
    """Backward from the saved (o, lse) → (dq, dk, dv) of this rank's
    shard."""
    if spec.axis_size == 1:
        return chunk_attn_bwd(q, k, v, o, lse, do, mask=spec.mask,
                              **_tune(spec), **_seg_kw(spec.mask, segments))
    if spec.mesh2d is not None:
        sched = resolve_schedule(spec, q, k, v, segments, for_bwd=True)
        seq, head = _comms2d(spec, group)
        if spec.mesh2d.u == 1:
            plan = sp.build_plan(sched, spec.mask, spec.mesh2d.r,
                                 q.shape[1])
            return sp.execute_bwd(plan, q, k, v, o, lse, do, segments,
                                  comm=seq, tune=_tune(spec))
        return sp.execute2d_bwd(_plan2d(spec, sched, q, k), q, k, v, o, lse,
                                do, segments, seq=seq, head=head,
                                tune=_tune(spec))
    comm = _comm(spec, group)
    sched = resolve_schedule(spec, q, k, v, segments, for_bwd=True)
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
    bwd = torch.is_grad_enabled() and any(t.requires_grad
                                          for t in (q, k, v))
    return FlashAttnFn.apply(
        q, k, v,
        lambda q, k, v: dist_attn_fwd(q, k, v, spec=spec, group=group,
                                      segments=segments, for_bwd=bwd),
        lambda q, k, v, o, lse, do: dist_attn_bwd(
            q, k, v, o, lse, do, spec=spec, group=group, segments=segments))


# --------------------------------------------------------------------------
# Decode-time distributed attention (flash-decoding over sequence shards)
# --------------------------------------------------------------------------

def _decode_local(comm, shard_len, window, scale, q, kc, vc, k1, v1,
                  pos=None):
    """q: (B,1,Hq,D) the same on every rank of ``comm``; kc/vc:
    (B,S_loc,Hkv,D) this rank's cache shard; k1/v1: (B,1,Hkv,D) the new
    token's k/v (the same on every rank).  ``pos`` (B,): request b's new
    token sits at position pos[b] and only cache slots < pos[b] are
    attendable (window measured from pos[b]).  Without ``pos`` (legacy)
    the whole cache is context: S_global cached + 1 new token at position
    S_global.  Float32 throughout, as the reference."""
    idx = 0 if comm is None else comm.rank
    n_shards = 1 if comm is None else comm.size
    S_total = n_shards * shard_len
    offset = idx * shard_len
    B, _, Hq, Dq = q.shape
    Hkv = kc.shape[2]
    g = Hq // Hkv
    sc = scale if scale is not None else 1.0 / (Dq ** 0.5)
    # query head h*g + j reads kv head h: contract the (B, Hkv, g) grouped
    # query against the unexpanded shard, no per-group copy of the cache
    qf = q.float().reshape(B, 1, Hkv, g, Dq)
    s_loc = torch.einsum("bqhgd,bkhd->bhgqk", qf, kc.float()).reshape(
        B, Hq, 1, -1) * sc
    kpos = (offset + torch.arange(shard_len, device=q.device))[
        None, None, None, :]
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=q.device)
    if pos is not None:
        # per-request masking: slot j attendable iff j < pos_b (and inside
        # the sliding window measured from the new token at pos_b)
        pb = pos.to(q.device).long()[:, None, None, None]
        ok = kpos < pb
        if window and window > 0:
            ok = ok & (kpos > pb - window)
        s_loc = torch.where(ok, s_loc, neg)
    elif window and window > 0:
        s_loc = torch.where(kpos > S_total - window, s_loc, neg)
    m_loc = s_loc.amax(dim=-1)                            # (B,H,1)
    m_glb = m_loc.clone()
    if comm is not None:
        comm.all_reduce_([m_glb], op="max")
    m_safe = m_glb.clamp_min(NEG_INF / 2)
    p_loc = torch.exp(s_loc - m_safe[..., None])
    # a shard with every slot masked contributes nothing
    p_loc = torch.where(m_loc[..., None] <= NEG_INF / 2,
                        torch.zeros_like(p_loc), p_loc)
    num = torch.einsum("bhgqk,bkhd->bhgqd",
                       p_loc.reshape(B, Hkv, g, 1, -1),
                       vc.float()).reshape(B, Hq, 1, vc.shape[-1])
    den = p_loc.sum(dim=-1)                               # (B,H,1)
    if comm is not None:
        comm.all_reduce_([num, den])
    empty = den == 0.0
    den_s = torch.where(empty, torch.ones_like(den), den)
    lse_c = torch.where(empty, neg, m_safe + torch.log(den_s))
    o_c = torch.where(empty[..., None], torch.zeros_like(num),
                      num / den_s[..., None])
    # merge with the new token's self-attention (the same on every rank,
    # added once — after the cross-shard sum so it is not counted n times)
    s1 = torch.einsum("bqhgd,bkhd->bhgqk", qf, k1.float()).reshape(
        B, Hq, 1, 1) * sc
    lse1 = s1[..., 0]                                     # (B,H,1): one key
    o1 = v1.float().transpose(1, 2).repeat_interleave(g, dim=1)  # B,Hq,1,D
    o_m, _ = _merge_bh(o_c, lse_c, o1, lse1)
    return o_m.transpose(1, 2).to(q.dtype)                # (B,1,Hq,Dv)


def _merge_bh(o1, lse1, o2, lse2):
    """Merge two partials in the (B,H,1,D) / (B,H,1) layout."""
    mx = torch.maximum(torch.maximum(lse1, lse2),
                       torch.tensor(NEG_INF, device=lse1.device))
    w1 = torch.exp(lse1 - mx)
    w2 = torch.exp(lse2 - mx)
    den = w1 + w2
    den_s = torch.where(den == 0.0, torch.ones_like(den), den)
    o = (o1 * w1[..., None] + o2 * w2[..., None]) / den_s[..., None]
    return o, mx + torch.log(den_s)


def dist_decode_attn(q, k_cache, v_cache, k_new, v_new, *, group=None,
                     mask: Optional[MaskSpec] = None, window=None,
                     scale=None, shard_len=None, pos=None):
    """One-token decode against a sequence-sharded KV cache.

    ``k_cache`` / ``v_cache`` (B, S_loc, Hkv, D) are this rank's shard:
    rank i of ``group`` (the :class:`~repro_torch.parallel.comm.Comm` over
    the cache's sequence axes, e.g. ``("data", "model")`` for
    ``long_500k``; None: one shard) holds global slots
    ``[i·S_loc, (i+1)·S_loc)``.  The query and the new token's k/v are the
    same on every rank.  Exact lse-weighted combine across shards
    (distributed flash-decoding: a max reduced with MAX, numerator and
    denominator with SUM), then one merge with the new token's
    self-attention.

    ``mask`` is of kind ``causal`` (the whole cache, the default) or
    ``sliding_window``; the removed ``window=`` kwarg raises
    ``TypeError``.  ``pos`` (B,) int: per-request context lengths (slots
    >= pos[b] are masked for request b, the window is measured from
    pos[b]); None keeps the whole-cache semantics; a scalar broadcasts
    over the batch with a one-shot DeprecationWarning.  Returns o
    (B, 1, Hq, D) in q's dtype.  The local part is plain PyTorch in
    float32, as the reference's."""
    if window is not None:
        raise TypeError(
            "dist_decode_attn(window=) was removed; pass "
            "mask=repro_torch.core.mask.{causal,sliding_window}(...)")
    if mask is None:
        mask = mk.causal()
    if mask.kinds - {"causal", "sliding_window"}:
        raise ValueError(
            f"dist_decode_attn serves causal/sliding_window masks only "
            f"(got {mask.kind!r}) — the decode token is last, so other "
            f"kinds have no decode meaning")
    if mask.q_offset or mask.kv_offset:
        raise ValueError("dist_decode_attn mask must be offset-free — "
                         "decode positions are derived from the cache "
                         "layout")
    if shard_len is None:
        shard_len = k_cache.shape[1]
    if pos is not None:
        pos = torch.as_tensor(pos)
        if pos.ndim == 0:
            mk.warn_legacy_once(
                "dist_decode_attn(pos=<scalar>)",
                "a (B,) per-request position vector")
            pos = pos.expand(q.shape[0])
    if group is not None and group.size == 1:
        group = None
    return _decode_local(group, shard_len, mask.window, scale, q, k_cache,
                         v_cache, k_new, v_new, pos)


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

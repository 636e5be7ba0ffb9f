"""DISTFLASHATTN entry points (port of the reference
``core/dist_attention.py``), the single-card part.

The reference shards the sequence over a mesh axis of ``P`` workers and
runs the ring / balanced / zigzag schedules (``core/schedule.py``) or the
ulysses / rsa baselines.  On one card ``P = 1``, where every schedule
reduces to the local chunk kernels: :func:`dist_attn_fwd` calls
:func:`~repro_torch.core.attention.chunk_attn` (kernel A) and
:func:`dist_attn_bwd` calls
:func:`~repro_torch.core.attention.chunk_attn_bwd` (kernels C and D), as the
reference's ``_fwd_local`` / ``_bwd_local`` do at ``axis_size == 1``.
``axis_size > 1`` raises: the multi-rank schedules are the next slice of
the port.

The backward is exposed on its own so that the rematerialization-aware
checkpointing (``core/remat.py``) can call it from the saved ``(o, lse)``
without rerunning the forward.  :func:`dist_flash_attn` is the
differentiable op for the plain and ``hf`` policies.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import mask as mk
from repro_torch.core.attention import chunk_attn, chunk_attn_bwd
from repro_torch.core.mask import MaskSpec
from repro_torch.kernels.flash_attention import FlashAttnFn

SCHEDULES = ("auto", "balanced", "ring", "rsa", "ulysses", "zigzag")

_MASK_HINT = ("mask=repro_torch.core.mask.{full,causal,sliding_window,"
              "prefix_lm,document}(...)")


@dataclasses.dataclass(frozen=True)
class DistAttnSpec:
    """Static description of one distributed-attention call site.

    ``axis_size`` is the number of sequence-parallel ranks; the port runs
    ``axis_size == 1``, and the mesh axis name arrives with the schedules
    slice.  ``schedule`` ∈ :data:`SCHEDULES` (validated: a typo raises).  ``mask``
    is the MaskSpec of the whole (unsharded) attention and must be
    offset-free; it defaults to causal.  The removed ``causal=`` /
    ``window=`` kwargs raise ``TypeError``.  The mask/schedule checks for
    ``axis_size > 1`` are the reference's, so a spec the reference refuses
    is refused here too.
    """
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


def _local(spec: DistAttnSpec, what: str):
    if spec.axis_size != 1:
        raise NotImplementedError(
            f"{what} with axis_size={spec.axis_size}: the sequence-parallel "
            f"schedules (core/schedule.py: balanced, ring, zigzag, "
            f"ulysses/rsa, auto) are the next slice of the port; one card "
            f"runs axis_size=1")


def _seg_kw(mask: MaskSpec, segments) -> dict:
    """Segment operands, only when the mask consumes them."""
    if not mask.document or segments is None:
        return {}
    return dict(q_segments=segments, kv_segments=segments)


def dist_attn_fwd(q, k, v, *, spec: DistAttnSpec, segments=None):
    """Forward → (o, lse).  q (B,T,Hq,D), k/v (B,T,Hkv,D); ``segments``
    (B, T) document ids (document masks only)."""
    _local(spec, "dist_attn_fwd")
    return chunk_attn(q, k, v, mask=spec.mask, scale=spec.scale,
                      impl=spec.impl, **_seg_kw(spec.mask, segments))


def dist_attn_bwd(q, k, v, o, lse, do, *, spec: DistAttnSpec,
                  segments=None):
    """Backward from the saved (o, lse) → (dq, dk, dv)."""
    _local(spec, "dist_attn_bwd")
    return chunk_attn_bwd(q, k, v, o, lse, do, mask=spec.mask,
                          scale=spec.scale, impl=spec.impl,
                          **_seg_kw(spec.mask, segments))


def dist_flash_attn(q, k, v, spec: DistAttnSpec, segments=None):
    """DISTFLASHATTN with autograd: (o, lse), whose backward is
    :func:`dist_attn_bwd` from the saved (o, lse).  lse is a residual
    output (its gradient is ignored); ``segments`` is not
    differentiable."""
    return FlashAttnFn.apply(
        q, k, v,
        lambda q, k, v: dist_attn_fwd(q, k, v, spec=spec, segments=segments),
        lambda q, k, v, o, lse, do: dist_attn_bwd(
            q, k, v, o, lse, do, spec=spec, segments=segments))

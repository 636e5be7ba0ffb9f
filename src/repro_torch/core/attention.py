"""Chunk-attention API, forward and backward (port of the reference
``core/attention.py``).

A *partial* attention op returns ``(o, lse)`` for one (q-chunk, kv-chunk)
pair; partials merge exactly with :func:`merge`.  The mask is a static
:class:`~repro_torch.core.mask.MaskSpec`; integer ``q_offset``/``kv_offset``
operands fold into it (``mask.fold_offsets``), so kernel A always sees a
static spec.  ``impl`` names a backend of :mod:`repro_torch.kernels.registry`
(``ref`` or ``cuda``, the default, whose wrappers run the plain versions on
CPU tensors).
"""
from __future__ import annotations

import torch

from repro_torch.core import mask as mk
from repro_torch.core.mask import MaskSpec
from repro_torch.kernels import registry
from repro_torch.kernels.ref import NEG_INF, merge_ref


def chunk_attn(q, k, v, *, mask: MaskSpec | None = None, scale=None,
               impl=None, q_segments=None, kv_segments=None, q_offset=None,
               kv_offset=None):
    """Partial attention under a static ``mask``; q (B,Tq,Hq,D), k/v
    (B,Tk,Hkv,D).  Returns (o (B,Tq,Hq,D), lse (B,Tq,Hq) float32)."""
    mask = mk.fold_offsets(mk.full() if mask is None else mask, q_offset,
                           kv_offset)
    be = registry.resolve(impl)
    return be.fwd(q, k, v, mask=mask, scale=scale, q_segments=q_segments,
                  kv_segments=kv_segments)


def chunk_attn_bwd(q, k, v, o, lse, do, *, mask: MaskSpec | None = None,
                   scale=None, impl=None, delta=None, q_segments=None,
                   kv_segments=None, q_offset=None, kv_offset=None):
    """FlashAttention-2 backward of one chunk from the saved (o, lse) — no
    forward recompute.  ``delta = rowsum(o ⊙ do)`` may be precomputed.
    ``q_offset``/``kv_offset`` fold into the mask as in :func:`chunk_attn`.
    Returns (dq, dk, dv)."""
    mask = mk.fold_offsets(mk.full() if mask is None else mask, q_offset,
                           kv_offset)
    be = registry.resolve(impl)
    return be.bwd(q, k, v, o, lse, do, mask=mask, scale=scale, delta=delta,
                  q_segments=q_segments, kv_segments=kv_segments)


def paged_decode_attn(q, k_pool, v_pool, block_table, lengths, *,
                      mask: MaskSpec | None = None, scale=None, impl=None):
    """Decode attention through a paged KV cache, T >= 1 query tokens per
    request (row t of request b sits at position ``lengths[b] - T + t``;
    all T tokens' K/V are already written).  ``mask`` is causal or
    sliding_window.  Returns o (B, T, Hq, D)."""
    mask = mk.causal() if mask is None else mask
    be = registry.resolve(impl)
    return be.paged_fwd(q, k_pool, v_pool, block_table, lengths, mask=mask,
                        scale=scale)


merge = merge_ref  # (o1, lse1, o2, lse2) -> (o, lse)


def mask_partial(pred: bool, o, lse):
    """The partial ``(o, lse)`` where ``pred`` holds, else the empty partial
    (zeros, NEG_INF) of the same shapes.  ``pred`` is a Python bool: each
    rank knows its own index, so the choice is made on the host."""
    if pred:
        return o, lse
    return torch.zeros_like(o), torch.full_like(lse, NEG_INF)


def empty_partial(q):
    """Identity element of ``merge`` for a query chunk."""
    B, T, H, _ = q.shape
    return (torch.zeros(q.shape, dtype=q.dtype, device=q.device),
            torch.full((B, T, H), NEG_INF, dtype=torch.float32,
                       device=q.device))

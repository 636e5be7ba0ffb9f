"""Attention backend registry: three names.

  * ``cuda`` — the default: the kernel wrappers (``flash_attention.flash_fwd``,
               ``flash_attention.flash_bwd``, ``paged.paged_attn``).  For CPU
               tensors they run their plain versions; for CUDA tensors they
               launch the hand-written Hopper kernels.
  * ``ref``  — the plain PyTorch versions (``chunk_attn_ref``,
               ``chunk_attn_bwd_ref``, ``paged_attn_ref``) on any device: the
               oracle a caller may ask for explicitly.
  * ``null`` — the dry-run's O(T) stub (``launch/dryrun.py``), reached only
               by name and registered as not exact: shape-correct outputs
               that depend on every input (o the mean of v broadcast, plus
               ``0 · q[..., :1] · mean(k)``; lse the mean of q; the
               gradients ``0 · x + mean(do)``), so a count of the step
               around the attention keeps every surrounding op and
               collective while the attention's own O(T²) work drops out
               (its ideal cost is added analytically,
               ``analysis/roofline.attention_analytic``).

There is no downgrade walk: a CUDA call the kernel cannot serve (mask kind,
dtype, head dim) raises in the kernel's wrapper.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

from repro_torch.kernels.flash_attention import flash_bwd, flash_fwd
from repro_torch.kernels.paged import paged_attn, paged_attn_ref
from repro_torch.kernels.ref import chunk_attn_bwd_ref, chunk_attn_ref


@dataclasses.dataclass(frozen=True)
class Backend:
    """``fwd(q, k, v, *, mask, scale, q_segments, kv_segments) -> (o, lse)``;
    ``bwd(q, k, v, o, lse, do, *, mask, scale, delta, q_segments,
    kv_segments) -> (dq, dk, dv)``; ``paged_fwd(q, k_pool, v_pool,
    block_table, lengths, *, mask, scale) -> o`` (None for ``null``, as
    the reference's); ``exact`` False for a stub."""
    name: str
    fwd: Callable
    paged_fwd: Optional[Callable]
    bwd: Callable
    exact: bool = True


def _null_fwd(q, k, v, *, mask=None, scale=None, q_segments=None,
              kv_segments=None):
    B, Tq, Hq, _ = q.shape
    vm = v.float().mean(dim=(1, 2), keepdim=True)
    o = vm.expand(B, Tq, Hq, v.shape[-1]).to(q.dtype)
    o = o + 0.0 * q[..., :1] * k.mean()
    return o, q.float().mean(dim=-1)


def _null_bwd(q, k, v, o, lse, do, *, mask=None, scale=None, delta=None,
              q_segments=None, kv_segments=None):
    s = do.float().mean()
    return tuple((x.float() * 0.0 + s).to(x.dtype) for x in (q, k, v))


_REGISTRY = {
    "ref": Backend("ref", chunk_attn_ref, paged_attn_ref, chunk_attn_bwd_ref),
    "cuda": Backend("cuda", flash_fwd, paged_attn, flash_bwd),
    "null": Backend("null", _null_fwd, None, _null_bwd, exact=False),
}


def names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get(name: str) -> Backend:
    if name not in _REGISTRY:
        raise ValueError(f"unknown attention backend {name!r}; "
                         f"registered: {names()}")
    return _REGISTRY[name]


def resolve(impl) -> Backend:
    """The backend ``impl`` names, ``cuda`` when it is None, or ``impl``
    itself when it is a :class:`Backend` (a caller's own pair of
    functions, e.g. a deliberately wrong backward as a test control)."""
    if isinstance(impl, Backend):
        return impl
    return get("cuda" if impl is None else impl)

"""Attention backend registry: two names.

  * ``cuda`` — the default: the kernel wrappers (``flash_attention.flash_fwd``,
               ``paged.paged_attn``).  For CPU tensors they run their plain
               versions; for CUDA tensors they launch the hand-written
               Hopper kernels.
  * ``ref``  — the plain PyTorch versions (``chunk_attn_ref``,
               ``paged_attn_ref``) on any device: the oracle a caller may ask
               for explicitly.

There is no downgrade walk: a CUDA call the kernel cannot serve (mask kind,
dtype, head dim) raises in the kernel's wrapper.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

from repro_torch.kernels.flash_attention import flash_fwd
from repro_torch.kernels.paged import paged_attn, paged_attn_ref
from repro_torch.kernels.ref import chunk_attn_ref


@dataclasses.dataclass(frozen=True)
class Backend:
    """``fwd(q, k, v, *, mask, scale, q_segments, kv_segments) -> (o, lse)``;
    ``paged_fwd(q, k_pool, v_pool, block_table, lengths, *, mask, scale)
    -> o``."""
    name: str
    fwd: Callable
    paged_fwd: Callable


_REGISTRY = {
    "ref": Backend("ref", chunk_attn_ref, paged_attn_ref),
    "cuda": Backend("cuda", flash_fwd, paged_attn),
}


def names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get(name: str) -> Backend:
    if name not in _REGISTRY:
        raise ValueError(f"unknown attention backend {name!r}; "
                         f"registered: {names()}")
    return _REGISTRY[name]


def resolve(impl: Optional[str]) -> Backend:
    """The backend ``impl`` names, or ``cuda`` when it is None."""
    return get("cuda" if impl is None else impl)

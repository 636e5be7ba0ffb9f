"""Static block-sparsity ranges for the chunk-attention kernel (port of the
reference ``kernels/block_sparse.py``).

Because every MaskSpec is static, the set of (q-block, kv-block) tiles the
mask can reach is known on the host before a launch.  The flash-forward
wrapper (``flash_attention.py``) turns these ranges into a small int32
table the kernel reads per q tile.

Q block ``i`` covers absolute query positions ``[q_offset + i*br,
q_offset + (i+1)*br - 1]``; KV block ``j`` covers ``[kv_offset + j*bc,
kv_offset + (j+1)*bc - 1]``.  All bounds are inclusive; an empty range is
``hi < lo``.  Plain Python integers throughout.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.mask import MaskSpec


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pick_block(T: int, block: int) -> int:
    """Largest divisor of T that is ≤ ``block``; T itself when no divisor of
    at least min(32, T) exists."""
    b = min(block, T)
    while T % b:
        b -= 1
    if b < min(32, T):
        return T
    return b


def _prefix_blocks(mask: MaskSpec, bc: int) -> int:
    """Number of KV blocks overlapping the bidirectional prefix."""
    if not mask.prefix_len or mask.prefix_len <= mask.kv_offset:
        return 0
    return _cdiv(mask.prefix_len - mask.kv_offset, bc)


def kv_block_bounds(i: int, *, br: int, bc: int, nk: int, mask: MaskSpec):
    """Inclusive (lo, hi) of KV blocks that q block ``i`` can attend to."""
    qs = mask.q_offset + i * br
    qe = qs + br - 1
    ko = mask.kv_offset
    hi = min(nk - 1, (qe - ko) // bc) if mask.causal else nk - 1
    lo = (max(0, _cdiv(qs - mask.window + 2 - ko, bc) - 1)
          if mask.window else 0)
    pb = _prefix_blocks(mask, bc)
    if pb > 0:
        lo = 0
        hi = max(hi, min(nk - 1, pb - 1))
    if mask.document and mask.boundaries is not None:
        lo = max(lo, max(0, (mask.doc_start(qs) - ko) // bc))
        hi = min(hi, (mask.doc_end(qe) - ko) // bc)
    return lo, hi


def interior_kv_bounds(i: int, *, br: int, bc: int, nk: int,
                       mask: MaskSpec):
    """Inclusive (lo, hi) of KV blocks the mask cannot touch for q block
    ``i`` (every pair in the tile attends), so the kernel may skip the
    position mask there.  Conservative."""
    qs = mask.q_offset + i * br
    qe = qs + br - 1
    ko = mask.kv_offset
    hi = min(nk - 1, (qs + 1 - ko) // bc - 1) if mask.causal else nk - 1
    lo = (max(0, (qe - mask.window - ko) // bc + 1)
          if mask.window else 0)
    if mask.document:
        if mask.boundaries is None:
            return 1, 0                      # dynamic segments: no interior
        ds, de = mask.doc_start(qs), mask.doc_end(qs)
        lo = max(lo, max(0, _cdiv(ds - ko, bc)))
        hi = min(hi, (de + 1 - ko) // bc - 1)
        if mask.doc_start(qe) != ds:         # q spans a boundary
            hi = -1
    return lo, hi


@dataclasses.dataclass(frozen=True)
class GridProfile:
    """Static work profile of one pruned launch: ``row_counts[r]`` valid
    KV blocks for q block ``r``."""
    rows: int
    cols: int
    row_counts: tuple
    seq_grid: int          # max(row_counts)
    full_steps: int        # rows * cols — the dense sweep
    launched_steps: int    # rows * seq_grid
    executed_steps: int    # sum(row_counts)


def kv_profile(*, nq: int, nk: int, br: int, bc: int,
               mask: MaskSpec) -> GridProfile:
    """Work profile of the forward orientation (rows = q blocks)."""
    counts = []
    for i in range(nq):
        lo, hi = kv_block_bounds(i, br=br, bc=bc, nk=nk, mask=mask)
        counts.append(max(0, hi - lo + 1))
    seq = max(counts) if counts else 0
    return GridProfile(rows=nq, cols=nk, row_counts=tuple(counts),
                       seq_grid=seq, full_steps=nq * nk,
                       launched_steps=nq * seq, executed_steps=sum(counts))

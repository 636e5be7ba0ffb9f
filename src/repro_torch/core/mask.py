"""Declarative attention-mask specification — the ``MaskSpec`` API (port of
the reference ``core/mask.py``).

Mask kinds (constructors at module level):

  * ``full()``                 — no mask.
  * ``causal()``               — ``kv_pos <= q_pos``.
  * ``sliding_window(w)``      — causal ∧ ``q_pos − kv_pos < w``.
  * ``prefix_lm(n)``           — bidirectional over the first ``n`` absolute
                                 kv positions, causal after.
  * ``document(boundaries=…)`` — causal ∧ same-segment (packed sequences).

``MaskSpec`` is static (a frozen, hashable dataclass).  Per-token segment
IDs for document masks without static ``boundaries`` travel beside the
tensors as ``q_segments``/``kv_segments``.  ``q_offset``/``kv_offset`` are
the absolute positions of element 0 of each chunk.

Semantics of one (q, kv) position pair::

    pre  = prefix_len > 0 and kp < prefix_len
    ok   = (not causal  or kp <= qp      or pre)
         ∧ (not window  or qp − kp < w   or pre)
         ∧ (not document or seg(qp) == seg(kp) or pre)
"""
from __future__ import annotations

import bisect
import dataclasses
import numbers
import warnings
from typing import Optional, Tuple

import numpy as np
import torch


_DEPRECATION_WARNED = set()


def warn_legacy_once(site: str, hint: str) -> None:
    """One DeprecationWarning per call site per process, for the call forms
    the reference still accepts with a warning."""
    if site in _DEPRECATION_WARNED:
        return
    _DEPRECATION_WARNED.add(site)
    warnings.warn(f"{site} is deprecated; pass {hint}",
                  DeprecationWarning, stacklevel=4)


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    """Static attention-mask description (see module docstring)."""
    causal: bool = False
    window: int = 0                 # sliding-window width (0 = unlimited)
    prefix_len: int = 0             # bidirectional prefix (absolute kv pos)
    document: bool = False          # same-segment constraint
    q_offset: int = 0               # absolute position of q[0]
    kv_offset: int = 0              # absolute position of kv[0]
    # static document layout: sorted doc start positions, boundaries[0] == 0
    boundaries: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.window < 0:
            raise ValueError(f"window must be >= 0, got {self.window}")
        if self.prefix_len < 0:
            raise ValueError(f"prefix_len must be >= 0, got {self.prefix_len}")
        if self.prefix_len and not (self.causal or self.window):
            raise ValueError(
                "prefix_len only relaxes a causal/window mask; "
                "prefix_len without causal=True (or a window) is a no-op")
        if self.boundaries is not None:
            b = tuple(int(x) for x in self.boundaries)
            if not self.document:
                raise ValueError("boundaries given without document=True")
            if not b or b[0] != 0 or list(b) != sorted(set(b)):
                raise ValueError(
                    f"boundaries must be sorted, unique, and start at 0; "
                    f"got {b}")
            object.__setattr__(self, "boundaries", b)

    @property
    def kinds(self) -> frozenset:
        s = set()
        if self.causal:
            s.add("causal")
        if self.window:
            s.add("sliding_window")
        if self.prefix_len:
            s.add("prefix_lm")
        if self.document:
            s.add("document")
        return frozenset(s)

    @property
    def kind(self) -> str:
        """Primary label, for logs and case names."""
        for k in ("document", "prefix_lm", "sliding_window", "causal"):
            if k in self.kinds:
                return k
        return "full"

    @property
    def needs_mask(self) -> bool:
        return bool(self.kinds)

    @property
    def needs_segments(self) -> bool:
        """Segment-ID arrays required (document without a static layout)."""
        return self.document and self.boundaries is None

    @property
    def prunable(self) -> bool:
        """The block-sparse pruner can bound the valid KV blocks."""
        return (self.causal or self.window > 0
                or (self.document and self.boundaries is not None))

    def replace(self, **kw) -> "MaskSpec":
        return dataclasses.replace(self, **kw)

    # ----------------------------------------------- position-level masks
    def doc_start(self, p: int) -> int:
        """Start position of the document holding absolute position ``p``."""
        return self.boundaries[max(self.segment_index(p), 0)]

    def doc_end(self, p: int) -> int:
        """Last position of the document holding ``p`` (2**30 past the last
        boundary)."""
        i = self.segment_index(p)
        return (self.boundaries[i + 1] - 1 if i + 1 < len(self.boundaries)
                else 2 ** 30)

    def segment_index(self, p: int) -> int:
        """Segment index of absolute position ``p`` (static boundaries)."""
        return bisect.bisect_right(self.boundaries, int(p)) - 1

    def segment_of(self, pos: torch.Tensor) -> torch.Tensor:
        """Segment index of each absolute position in ``pos``."""
        seg = torch.zeros(pos.shape, dtype=torch.int32, device=pos.device)
        for b in self.boundaries[1:]:
            seg = seg + (pos >= b).to(torch.int32)
        return seg

    def allow(self, q_pos, kv_pos, q_segments=None, kv_segments=None):
        """Boolean attend-mask from broadcastable torch position (and
        segment) tensors, or ``None`` when nothing is masked."""
        m = None

        def _and(a, b):
            return b if a is None else a & b

        pre = kv_pos < self.prefix_len if self.prefix_len else None
        if self.causal:
            c = kv_pos <= q_pos
            m = _and(m, c | pre if pre is not None else c)
        if self.window:
            w = q_pos - kv_pos < self.window
            m = _and(m, w | pre if pre is not None else w)
        if self.document:
            if q_segments is None or kv_segments is None:
                if self.boundaries is None:
                    raise ValueError(
                        "document mask needs q_segments/kv_segments "
                        "(or static boundaries)")
                q_segments = self.segment_of(q_pos)
                kv_segments = self.segment_of(kv_pos)
            d = q_segments == kv_segments
            m = _and(m, d | pre if pre is not None else d)
        return m


# --------------------------------------------------------------------------
# Constructors
# --------------------------------------------------------------------------

def full(rel_offset: int = 0) -> MaskSpec:
    return MaskSpec(q_offset=rel_offset)


def causal(rel_offset: int = 0) -> MaskSpec:
    return MaskSpec(causal=True, q_offset=rel_offset)


def sliding_window(window: int, *, causal: bool = True,
                   rel_offset: int = 0) -> MaskSpec:
    return MaskSpec(causal=causal, window=window, q_offset=rel_offset)


def prefix_lm(prefix_len: int, rel_offset: int = 0) -> MaskSpec:
    return MaskSpec(causal=True, prefix_len=prefix_len, q_offset=rel_offset)


def document(*, boundaries: Optional[Tuple[int, ...]] = None,
             causal: bool = True, window: int = 0,
             rel_offset: int = 0) -> MaskSpec:
    return MaskSpec(causal=causal, window=window, document=True,
                    q_offset=rel_offset,
                    boundaries=None if boundaries is None
                    else tuple(boundaries))


def doc_boundaries(T: int, n_docs: int) -> Tuple[int, ...]:
    """Deterministic uneven packing layout: ``n_docs`` documents over a
    length-``T`` sequence with lengths proportional to 1..n (remainder to
    the last doc) — the reference's layout, shared with its data pipeline."""
    if n_docs <= 1 or T < n_docs:
        return (0,)
    total = n_docs * (n_docs + 1) // 2
    lens = [max(1, (i + 1) * T // total) for i in range(n_docs - 1)]
    if sum(lens) >= T:                 # tiny T: fall back to equal split
        lens = [T // n_docs] * (n_docs - 1)
    starts = [0]
    for ln in lens:
        starts.append(starts[-1] + ln)
    return tuple(starts)


def segments_from_boundaries(T: int, boundaries: Tuple[int, ...]):
    """(T,) int32 numpy segment ids of a static layout."""
    seg = np.zeros((T,), np.int32)
    for b in boundaries[1:]:
        seg[b:] += 1
    return seg


# --------------------------------------------------------------------------
# Per-step specs of the distributed schedules (core/schedule.py)
# --------------------------------------------------------------------------

def ring_step(mask: MaskSpec, rel: int) -> MaskSpec:
    """Per-step spec for a ring schedule receiving a strictly-past KV chunk
    at distance ``rel`` (> 0): the causal constraint is statically
    satisfied, so it is dropped; window / document constraints remain.
    Static ``boundaries`` are stripped (absolute coordinates mean nothing
    under per-step relative offsets): the schedule executor derives
    per-shard segment arrays from them instead."""
    return mask.replace(causal=False, q_offset=rel, kv_offset=0,
                        boundaries=None)


def strict_causal_pair(mask: MaskSpec) -> MaskSpec:
    """Per-step spec for a (q-chunk, kv-chunk) pair the schedule proves
    strictly causal (balanced/zigzag off-diagonal pairs): only the document
    constraint survives; positions are irrelevant (``boundaries`` stripped,
    as in :func:`ring_step`)."""
    return mask.replace(causal=False, window=0, q_offset=0, kv_offset=0,
                        boundaries=None)


def offdiag_step(mask: MaskSpec) -> MaskSpec:
    """Per-step spec for a strictly-causal pair whose chunk distance varies
    per rank (zigzag mirror-chunk pairs): the causal constraint is dropped,
    the window band survives, and each rank folds its own chunk offsets in
    as integers (:func:`fold_offsets`), so the spec's offsets stay 0."""
    return mask.replace(causal=False, q_offset=0, kv_offset=0,
                        boundaries=None)


def chunk_pair_needed(mask: MaskSpec, q_lo: int, q_hi: int,
                      k_lo: int, k_hi: int) -> bool:
    """Could any ``(qp, kp)`` with ``qp ∈ [q_lo, q_hi]``, ``kp ∈ [k_lo,
    k_hi]`` attend under ``mask`` (absolute positions)?  Conservative:
    ``False`` only when the pair is provably all-masked, which lets the
    schedule planner drop steps and work items statically.  Dynamic
    segment arrays are unknowable here and never cause pruning; static
    ``boundaries`` do."""
    if mask.prefix_len:
        return True
    if mask.causal and k_lo > q_hi:
        return False                     # strictly future chunk
    if mask.window and mask.window > 0:
        if max(q_lo - k_hi, 0) >= mask.window:
            return False                 # whole pair beyond the band
    if mask.document and mask.boundaries is not None:
        if (mask.segment_index(q_hi) < mask.segment_index(k_lo)
                or mask.segment_index(k_hi) < mask.segment_index(q_lo)):
            return False
    return True


# --------------------------------------------------------------------------
# Speculation-tree masks (serve/speculative.py)
# --------------------------------------------------------------------------
#
# A verify chunk appends a small tree of draft tokens after the committed
# context: node i attends the whole context and its own ancestors, never a
# sibling branch.  A chain is plain ``causal``; a star of contiguous linear
# branches is ``causal ∧ document`` (one document per branch) with
# ``prefix_len`` spanning the shared context.  Re-branching trees are not
# expressible as a MaskSpec and are rejected.

def chain_parents(n: int) -> Tuple[int, ...]:
    """Parent vector of a depth-``n`` chain (node i's parent is i − 1; the
    root's, −1, is the committed context)."""
    return tuple(range(-1, n - 1))


def tree_ancestor_mask(parents: Tuple[int, ...]) -> np.ndarray:
    """(K, K) bool: ``m[i, j]`` iff node j is node i or one of its
    ancestors — the ground truth :func:`tree_spec` must reproduce."""
    K = len(parents)
    m = np.zeros((K, K), bool)
    for i, p in enumerate(parents):
        m[i, i] = True
        while p >= 0:
            m[i, p] = True
            p = parents[p]
    return m


def _tree_branches(parents: Tuple[int, ...]) -> Tuple[int, ...]:
    """Branch start indices of a star of contiguous linear branches hanging
    off the context (parent −1); raises for any other topology."""
    parents = tuple(int(p) for p in parents)
    if not parents:
        raise ValueError("empty speculation tree")
    starts = []
    for i, p in enumerate(parents):
        if p == -1:
            starts.append(i)
        elif p != i - 1:
            raise ValueError(
                f"node {i} has parent {p}; only chains and stars of "
                f"contiguous linear branches are MaskSpec-expressible")
    if starts[0] != 0:
        raise ValueError("node 0 must hang off the context (parent -1)")
    return tuple(starts)


def tree_spec(parents: Tuple[int, ...], *, prefix_len: int = 0,
              window: int = 0) -> MaskSpec:
    """The static MaskSpec of one verify chunk whose draft tokens form the
    tree ``parents`` (``parents[i]`` is node i's parent, −1 = the committed
    context).  A chain (and the single node, a vanilla decode step) is
    ``causal``; a star of ``m > 1`` branches is ``causal ∧ document`` with
    the branch starts as ``boundaries`` and ``prefix_len`` so that every
    branch still sees the committed context.  ``window`` carries a
    sliding-window model's band."""
    starts = _tree_branches(parents)
    if len(starts) == 1:
        return MaskSpec(causal=True, window=int(window))
    # the context shares segment 0 with the first branch; the other
    # branches see it through the prefix relaxation
    return MaskSpec(causal=True, window=int(window),
                    prefix_len=int(prefix_len), document=True,
                    boundaries=(0,) + tuple(int(prefix_len) + s
                                            for s in starts[1:]))


def _static_int(x) -> int:
    """A Python int, a numpy integer, or a 0-d integer tensor, as an int."""
    if isinstance(x, torch.Tensor):
        if x.ndim or x.dtype.is_floating_point:
            raise TypeError(f"offset must be a 0-d integer tensor, got "
                            f"{tuple(x.shape)} {x.dtype}")
        return int(x.item())
    if isinstance(x, (numbers.Integral, np.integer)):
        return int(x)
    raise TypeError(f"offset must be an integer, got {type(x).__name__}")


def fold_offsets(mask: MaskSpec, q_offset, kv_offset) -> MaskSpec:
    """Fold position operands into the static spec.  Every offset the port
    sees is a host integer (the engine's chunk ``start`` is a Python int),
    so there is no dynamic-offset path: Python ints, numpy integers and 0-d
    integer tensors all fold, so the kernels and the block-sparse pruner
    always see a fully static spec."""
    qo = 0 if q_offset is None else _static_int(q_offset)
    ko = 0 if kv_offset is None else _static_int(kv_offset)
    if qo or ko:
        mask = mask.replace(q_offset=mask.q_offset + qo,
                            kv_offset=mask.kv_offset + ko)
    return mask

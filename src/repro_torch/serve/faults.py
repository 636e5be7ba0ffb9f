"""Deterministic, seeded fault injection for the serving stack, and the
structured failure types the engine raises (port of the reference
``serve/faults.py``).

A :class:`FaultInjector` carries a static, seeded schedule of
:class:`FaultEvent`\\ s that the engine applies at the matching step
indices.  The schedule is pure data and every fault is applied at a fixed
point of the host-side step loop, so a fault sequence replays exactly: the
same seed gives the same schedule, quarantines, preemptions and token
streams — and, since the schedule is drawn with numpy exactly as the
reference draws it, the same storm in both packages.

Fault kinds (``FaultEvent.kind``):

  ``squeeze``         hold up to ``magnitude`` free pool blocks for
                      ``duration`` steps (pool pressure);
  ``nan_logits``      poison one live decode row's logits with NaN this
                      step (that request must be quarantined);
  ``drop_step``       the decode step is dropped: no token lands, the
                      engine retries with capped exponential backoff;
  ``slow_step``       ``magnitude`` extra ticks of the scheduler's virtual
                      clock (deadline pressure);
  ``corrupt_block``   NaN over one live request's exclusively owned pool
                      block (seen downstream as NaN logits);
  ``preempt_storm``   force-preempt the ``magnitude`` youngest running
                      requests.

``target`` is a pick index into the sorted list of eligible victims at
fire time, not a request id.  The injector never mutates engine state: the
engine asks :meth:`FaultInjector.events_for`, applies each event through
the cache and scheduler APIs and records what happened with
:meth:`FaultInjector.fired`; ``log`` is the fault trace a test compares
across runs.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Sequence, Tuple

import numpy as np

#: every fault kind the injector can schedule
KINDS = ("squeeze", "nan_logits", "drop_step", "slow_step",
         "corrupt_block", "preempt_storm")

#: allocator owner id under which fault-held blocks are parked (they stay
#: owned, so allocator conservation holds mid-squeeze)
FAULT_OWNER = -2


class AuditFailure(AssertionError):
    """A serving invariant was violated (``Engine(audit=True)``).

    ``invariant`` names the violated check (``allocator_conservation``,
    ``prefix_trie``, ``table_ownership``) and ``detail`` carries the
    failing evidence."""

    def __init__(self, invariant: str, detail: str = ""):
        self.invariant = invariant
        self.detail = detail
        super().__init__(f"audit failed: {invariant}"
                         + (f" — {detail}" if detail else ""))


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault (see the module docstring for the kinds)."""
    step: int                 # engine step index (0-based) at which it fires
    kind: str
    target: int = 0           # pick index into the sorted victim candidates
    magnitude: int = 1        # blocks squeezed / clock ticks / storm size
    duration: int = 1         # steps a squeeze is held

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(kinds: {KINDS})")
        if self.step < 0 or self.magnitude < 1 or self.duration < 1:
            raise ValueError(f"malformed fault event: {self}")


class FaultInjector:
    """A static schedule of :class:`FaultEvent`\\ s plus the fire log."""

    def __init__(self, events: Iterable[FaultEvent] = ()):
        self.events: Tuple[FaultEvent, ...] = tuple(
            sorted(events, key=lambda e: (e.step, e.kind, e.target)))
        self.log: List[Tuple[int, str, str]] = []   # (step, kind, detail)
        self.counts = {k: 0 for k in KINDS}

    @classmethod
    def seeded(cls, seed: int, *, n_steps: int = 32, rate: float = 0.3,
               kinds: Sequence[str] = KINDS,
               max_magnitude: int = 3,
               max_duration: int = 3) -> "FaultInjector":
        """A seeded storm: each step in ``[0, n_steps)`` fires one fault
        with probability ``rate``, its kind, target, magnitude and duration
        drawn from ``numpy.random.default_rng(seed)``."""
        for k in kinds:
            if k not in KINDS:
                raise ValueError(f"unknown fault kind {k!r}")
        rng = np.random.default_rng(seed)
        events = []
        for s in range(n_steps):
            if rng.random() >= rate:
                continue
            events.append(FaultEvent(
                step=s,
                kind=kinds[int(rng.integers(len(kinds)))],
                target=int(rng.integers(0, 8)),
                magnitude=1 + int(rng.integers(0, max_magnitude)),
                duration=1 + int(rng.integers(0, max_duration))))
        return cls(events)

    @property
    def horizon(self) -> int:
        """First step past every scheduled fault, squeeze holds included."""
        return max((e.step + e.duration for e in self.events), default=0)

    def events_for(self, step: int) -> List[FaultEvent]:
        return [e for e in self.events if e.step == step]

    def fired(self, step: int, kind: str, detail: str) -> None:
        """Record a fault the engine applied (or skipped for lack of a
        victim; the detail says which)."""
        self.log.append((step, kind, detail))
        self.counts[kind] += 1

    def pick(self, event: FaultEvent, candidates: Sequence) -> object:
        """``target`` modulo the (caller-sorted) candidates; None when
        there is none."""
        if not candidates:
            return None
        return candidates[event.target % len(candidates)]

"""The structured failure types the serving stack raises (the part of the
reference ``serve/faults.py`` that the cache and scheduler use; seeded
fault injection itself is not ported yet)."""
from __future__ import annotations

#: allocator owner id under which fault-held blocks are parked
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

"""The tuning table: schema, validation, lookups, resolution (port of the
reference ``tune/table.py``; the same JSON document).

.. code-block:: text

    {
      "schema_version": 1,
      "generated_by": "...",
      "host": {"platform": "...", ...},
      "kernel":   [ {backend, platform, mask_kind, head_dim, seq, op,
                     block_q, block_kv, wall_us, sweep: {...}} ],
      "schedule": [ {mask_kind, P, seq, Hq, Hkv, Dqk, best,
                     wall_us: {schedule: us}} ],
      "paged":    [ {layout, sharding, block_size, tokens_per_s,
                     sweep: {...}} ],
      "calibration": {coeffs: {s_per_flop, s_per_byte, s_per_hop, base_s},
                      fit: {...}}
    }

Lookups are nearest-bucket: exact on the categorical keys, nearest in
log2 space on ``seq`` and ``head_dim``.  A missing, corrupt or
mismatched table gives None, with one logged warning per process and path:
tuning never turns into a crash.

:func:`active_table` resolves, once a process (:func:`reset` drops the
cache): an explicit :func:`set_table`; ``REPRO_TUNE_TABLE=<path>``; the
bundled ``tables/default_<platform>.json`` (``cuda`` where a CUDA device
is available, else ``cpu``); else None.  ``REPRO_TUNE=off`` gives None.
No table ships with the port (``tune/sweep.py`` writes one).

Consumers: ``core/schedule.choose_schedule`` (:meth:`TuningTable.
best_schedule`, :meth:`TuningTable.coeffs`) and ``serve/cache.
PagedKVCache.default_block_size`` (:meth:`TuningTable.best_block_size`,
after ``REPRO_TUNE_BLOCK_SIZE``).  :meth:`TuningTable.best_blocks` has no
consumer: the port's kernels have fixed tiles.
"""
from __future__ import annotations

import json
import logging
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

log = logging.getLogger(__name__)

SCHEMA_VERSION = 1

# the keys a row of each section must have
_REQUIRED = {
    "kernel": ("backend", "platform", "mask_kind", "head_dim", "seq", "op",
               "block_q", "block_kv"),
    "schedule": ("mask_kind", "P", "seq", "best", "wall_us"),
    "paged": ("layout", "sharding", "block_size"),
}


class TableError(ValueError):
    """A table that cannot be loaded or does not validate (path, reason)."""

    def __init__(self, path, reason):
        self.path, self.reason = path, reason
        super().__init__(f"tuning table {path!r}: {reason}")


def _log_dist(a: float, b: float) -> float:
    """Distance in log2 space (values below 1 count as 1)."""
    a, b = max(float(a), 1.0), max(float(b), 1.0)
    return abs(math.log2(a) - math.log2(b))


class TuningTable:
    """One tuning-table document (module docstring)."""

    def __init__(self, data: dict, path: Optional[str] = None):
        self.data = data
        self.path = path
        errs = self.validate(data)
        if errs:
            raise TableError(path or "<dict>", "; ".join(errs[:3]))

    # ------------------------------------------------------------ schema
    @staticmethod
    def validate(data) -> List[str]:
        """The document's schema errors ([] when valid)."""
        errs = []
        if not isinstance(data, dict):
            return [f"document is {type(data).__name__}, expected object"]
        v = data.get("schema_version")
        if v != SCHEMA_VERSION:
            errs.append(f"schema_version {v!r} != supported {SCHEMA_VERSION}")
        for section, req in _REQUIRED.items():
            rows = data.get(section, [])
            if not isinstance(rows, list):
                errs.append(f"section {section!r} is not a list")
                continue
            for i, r in enumerate(rows):
                if not isinstance(r, dict):
                    errs.append(f"{section}[{i}] is not an object")
                    continue
                missing = [k for k in req if k not in r]
                if missing:
                    errs.append(f"{section}[{i}] missing {missing}")
        cal = data.get("calibration")
        if cal is not None:
            co = cal.get("coeffs") if isinstance(cal, dict) else None
            if not isinstance(co, dict) or not all(
                    isinstance(co.get(k), (int, float)) for k in
                    ("s_per_flop", "s_per_byte", "s_per_hop", "base_s")):
                errs.append("calibration.coeffs incomplete")
        return errs

    # -------------------------------------------------------- persistence
    @classmethod
    def load(cls, path: str) -> "TuningTable":
        """Parse and validate; raises :class:`TableError`."""
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise TableError(path, f"unreadable ({e})") from e
        return cls(data, path=path)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.data, f, indent=1, sort_keys=False)
            f.write("\n")
        self.path = path

    # ------------------------------------------------------------ lookups
    def best_blocks(self, *, backend: str, platform: str, mask_kind: str,
                    head_dim: int, seq: int,
                    op: str = "fwd") -> Optional[Tuple[int, int]]:
        """The winning ``(block_q, block_kv)`` of the nearest swept bucket:
        exact on (backend, platform, mask_kind, op), nearest on (seq,
        head_dim).  None when no row matches the exact keys.  Nothing in
        the port reads it: its kernels' tiles are fixed per route."""
        cands = [r for r in self.data.get("kernel", [])
                 if r["backend"] == backend and r["platform"] == platform
                 and r["mask_kind"] == mask_kind and r["op"] == op]
        if not cands:
            return None
        r = min(cands, key=lambda r: (_log_dist(r["seq"], seq)
                                      + _log_dist(r["head_dim"], head_dim),
                                      r["seq"], r["head_dim"]))
        return int(r["block_q"]), int(r["block_kv"])

    def best_schedule(self, *, mask_kind: str, P: int, seq: int,
                      candidates: Optional[Sequence[str]] = None,
                      ) -> Optional[str]:
        """The fastest measured schedule at the nearest (mask_kind, P, seq)
        bucket among ``candidates`` (the capable set of the call).  None
        when no row matches mask_kind and P, or no candidate was
        measured."""
        rows = [r for r in self.data.get("schedule", [])
                if r["mask_kind"] == mask_kind and int(r["P"]) == int(P)]
        if not rows:
            return None
        r = min(rows, key=lambda r: (_log_dist(r["seq"], seq), r["seq"]))
        walls = {k: v for k, v in r["wall_us"].items()
                 if isinstance(v, (int, float))}
        if candidates is not None:
            walls = {k: v for k, v in walls.items() if k in candidates}
        if not walls:
            return None
        return min(walls, key=lambda k: (walls[k], k))

    def best_block_size(self, *, layout: str,
                        sharding: str = "none") -> Optional[int]:
        """The paged cache's block size for (kv layout, pool sharding); the
        layout's row under any sharding when the pair was not swept."""
        rows = [r for r in self.data.get("paged", [])
                if r["layout"] == layout]
        if not rows:
            return None
        exact = [r for r in rows if r["sharding"] == sharding]
        return int((exact or rows)[0]["block_size"])

    def coeffs(self) -> Optional[Dict[str, float]]:
        """The calibrated cost-model coefficients, or None."""
        cal = self.data.get("calibration")
        if not cal:
            return None
        return dict(cal["coeffs"])

    def fit(self) -> Optional[dict]:
        cal = self.data.get("calibration")
        return dict(cal.get("fit", {})) if cal else None


# ==========================================================================
# The process-wide table
# ==========================================================================

_UNSET = object()
_ACTIVE = _UNSET                 # the resolved TuningTable | None
_EXPLICIT = _UNSET               # set_table()'s
_WARNED = set()                  # paths and variables warned about


def tables_dir() -> str:
    return os.path.join(os.path.dirname(__file__), "tables")


def platform() -> str:
    """The bundled table's platform: ``cuda`` where a CUDA device is
    available, else ``cpu``."""
    import torch
    return "cuda" if torch.cuda.is_available() else "cpu"


def bundled_default(name: str) -> Optional[str]:
    p = os.path.join(tables_dir(), f"default_{name}.json")
    return p if os.path.exists(p) else None


def _load_checked(path: str) -> Optional[TuningTable]:
    """Load, or None with one warning per process and path."""
    try:
        return TuningTable.load(path)
    except TableError as e:
        if path not in _WARNED:
            _WARNED.add(path)
            log.warning("ignoring tuning table %s (%s); falling back to "
                        "built-in heuristics", path, e.reason)
        return None


def set_table(table) -> None:
    """Force the active table: a :class:`TuningTable`, a path, or None (no
    table); :func:`reset` returns to the environment's resolution."""
    global _EXPLICIT, _ACTIVE
    if isinstance(table, str):
        table = _load_checked(table)
    _EXPLICIT = table
    _ACTIVE = _UNSET


def reset() -> None:
    """Drop the explicit table and the cached resolution."""
    global _EXPLICIT, _ACTIVE
    _EXPLICIT = _UNSET
    _ACTIVE = _UNSET


def active_table() -> Optional[TuningTable]:
    """The table the consumers read (module docstring); cached, so
    :func:`reset` after changing the environment."""
    global _ACTIVE
    if os.environ.get("REPRO_TUNE", "").lower() in ("off", "0", "false"):
        return None
    if _EXPLICIT is not _UNSET:
        return _EXPLICIT
    if _ACTIVE is _UNSET:
        path = os.environ.get("REPRO_TUNE_TABLE") or bundled_default(
            platform())
        _ACTIVE = _load_checked(path) if path else None
    return _ACTIVE


def env_int(name: str) -> Optional[int]:
    """An integer environment override, or None when unset or not an
    integer (the latter warned about once)."""
    v = os.environ.get(name)
    if not v:
        return None
    try:
        return int(v)
    except ValueError:
        if name not in _WARNED:
            _WARNED.add(name)
            log.warning("ignoring non-integer %s=%r", name, v)
        return None

"""Least-squares calibration of the schedule cost model (port of the
reference ``tune/calibrate.py``, in numpy).

``core/schedule.plan_cost`` predicts a schedule's cost from two analytic
terms (kernel FLOPs, hop-weighted link bytes) over the card's peak rates:
a roofline, not fitted to any measurement.  Calibration fits a linear
model to measured schedule rows,

    wall_s ≈ base_s + s_per_flop·flops + s_per_byte·comm_bytes
             + s_per_hop·hops + s_per_elem·score_elems

with nonnegative coefficients (``numpy.linalg.lstsq``, then
clamp-negative-and-refit).  ``score_elems`` is one kernel call's score
working set (``B·Hq·c²`` for the ring-family plans, ``B·(Hq/P)·Tg²`` for
ulysses, ``B·Hq·Tl·Tg`` for rsa): it tells "few big calls" from "many
small calls", which FLOPs and bytes alone do not.  The fit and its
diagnostics (residual, rank correlation against the measurements, the
same for the uncalibrated roofline) form a table's ``calibration``
section, whose coefficients ``choose_schedule`` ranks by where the table
has no measured row for the call.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

FEATURES = ("flops", "comm_bytes", "hops", "score_elems")
COEFF_OF = {"flops": "s_per_flop", "comm_bytes": "s_per_byte",
            "hops": "s_per_hop", "score_elems": "s_per_elem"}


def mask_for_kind(kind: str, *, T: int, window: Optional[int] = None):
    """A MaskSpec of a sweep row's mask kind (for its features only:
    document boundaries do not change ``plan_cost``)."""
    from repro_torch.core import mask as mk
    if kind == "causal":
        return mk.causal()
    if kind == "full":
        return mk.full()
    if kind == "sliding_window":
        return mk.sliding_window(window or max(T // 8, 1))
    if kind == "document":
        return mk.document()
    if kind == "prefix_lm":
        return mk.prefix_lm(max(T // 4, 1))
    raise ValueError(f"unknown mask kind {kind!r}")


def schedule_features(schedule: str, *, mask_kind: str, P: int, seq: int,
                      B: int = 1, Hq: int = 8, Hkv: Optional[int] = None,
                      Dqk: int = 64, Dv: Optional[int] = None,
                      bpe: int = 4, window: Optional[int] = None,
                      dynamic_seg: bool = False,
                      include_bwd: bool = False) -> Optional[Dict[str, float]]:
    """The feature vector of one (schedule, regime) point at global length
    ``seq``; None when the schedule cannot serve the mask or the heads do
    not divide."""
    from repro_torch.core import schedule as sp
    Hkv = Hq if Hkv is None else Hkv
    Dv = Dqk if Dv is None else Dv
    Tl = max(seq // P, 1)
    Tg = Tl * P
    m = mask_for_kind(mask_kind, T=seq, window=window)
    if schedule == "ulysses":
        if Hq % P or Hkv % P:
            return None
        cost = sp.ulysses_cost(m, P, Tl=Tl, B=B, Hq=Hq, Hkv=Hkv,
                               Dqk=Dqk, Dv=Dv, bpe=bpe)
        elems = B * (Hq / P) * float(Tg) * Tg
    elif schedule == "rsa":
        # the all-gather-KV baseline: Tl × Tg attention over every head
        # (pairs averaged over the ranks)
        if m.window:
            return None
        pairs = sp._band_pairs(m, Tg, Tg) / P if m.causal \
            else float(Tl) * Tg
        fl = 2.0 * B * Hq * pairs * (Dqk + Dv)
        cb = (P - 1) * B * Tl * Hkv * (Dqk + Dv) * bpe
        if include_bwd:
            fl += 2.0 * B * Hq * pairs * (3 * Dqk + 2 * Dv)
            cb *= 3.0
        return dict(flops=fl, comm_bytes=float(cb), hops=1.0,
                    score_elems=B * Hq * float(Tl) * Tg)
    else:
        if not sp.plan_capable(schedule, m):
            return None
        plan = sp.build_plan(schedule, m, P, Tl)
        cost = sp.plan_cost(plan, B=B, Hq=Hq, Hkv=Hkv, Dqk=Dqk, Dv=Dv,
                            bpe=bpe, dynamic_seg=dynamic_seg)
        c = plan.chunk_len
        elems = B * Hq * float(c) * c
    fl = cost.flops_fwd + (cost.flops_bwd if include_bwd else 0.0)
    cb = cost.comm_bytes_fwd + (cost.comm_bytes_bwd if include_bwd else 0.0)
    return dict(flops=fl, comm_bytes=cb, hops=float(cost.exec_steps),
                score_elems=elems)


def predict_s(feats: Dict[str, float], coeffs: Dict[str, float]) -> float:
    """The calibrated prediction, in seconds."""
    s = coeffs.get("base_s", 0.0)
    for f in FEATURES:
        s += coeffs.get(COEFF_OF[f], 0.0) * feats[f]
    return s


def fit_nonneg(X: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Nonnegative least squares by clamp-and-refit: solve without the
    constraint, drop every negative coefficient, refit over the rest until
    none is negative."""
    n = X.shape[1]
    active = list(range(n))
    w = np.zeros(n)
    for _ in range(n + 1):
        if not active:
            break
        sol, *_ = np.linalg.lstsq(X[:, active], y, rcond=None)
        neg = [a for a, s in zip(active, sol) if s < 0]
        if not neg:
            for a, s in zip(active, sol):
                w[a] = s
            break
        active = [a for a in active if a not in neg]
    return w


def spearman(a: Sequence[float], b: Sequence[float]) -> float:
    """Spearman rank correlation, ties at their average rank."""
    def ranks(v):
        v = np.asarray(v, dtype=float)
        order = np.argsort(v, kind="mergesort")
        r = np.empty(len(v))
        i = 0
        while i < len(v):
            j = i
            while j + 1 < len(v) and v[order[j + 1]] == v[order[i]]:
                j += 1
            r[order[i:j + 1]] = (i + j) / 2.0 + 1.0
            i = j + 1
        return r
    ra, rb = ranks(a), ranks(b)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = math.sqrt(float((ra ** 2).sum() * (rb ** 2).sum()))
    return float((ra * rb).sum() / denom) if denom else 0.0


def _row_points(rows: List[dict]
                ) -> List[Tuple[dict, str, Dict[str, float], float]]:
    """(row, schedule, features, wall_s) of every measured (regime,
    schedule) pair that has features."""
    pts = []
    for row in rows:
        for sched, us in sorted(row["wall_us"].items()):
            if not isinstance(us, (int, float)):
                continue
            feats = schedule_features(
                sched, mask_kind=row["mask_kind"], P=int(row["P"]),
                seq=int(row["seq"]), B=int(row.get("B", 1)),
                Hq=int(row.get("Hq", 8)), Hkv=row.get("Hkv"),
                Dqk=int(row.get("Dqk", 64)), bpe=int(row.get("bpe", 4)),
                window=row.get("window"),
                dynamic_seg=bool(row.get("dynamic_seg", False)))
            if feats is not None:
                pts.append((row, sched, feats, float(us) * 1e-6))
    return pts


def roofline_s(feats: Dict[str, float]) -> float:
    """The uncalibrated roofline's prediction (the fit's comparison)."""
    from repro_torch.analysis.roofline import schedule_cost_terms
    return schedule_cost_terms(flops=feats["flops"],
                               comm_bytes=feats["comm_bytes"]
                               )["step_s_lower_bound"]


def calibrate(rows: List[dict]) -> dict:
    """Fit the coefficients to measured schedule rows and report the
    relative RMS residual, the Spearman correlation of the calibrated and
    of the roofline predictions with the walls, and each regime's measured
    best against both models' picks: a table's ``calibration`` section."""
    pts = _row_points(rows)
    if len(pts) < len(FEATURES) + 1:
        raise ValueError(f"need at least {len(FEATURES) + 1} measured "
                         f"points to calibrate, got {len(pts)}")
    X = np.array([[f[k] for k in FEATURES] + [1.0] for _, _, f, _ in pts])
    y = np.array([w for _, _, _, w in pts])
    scale = X.max(axis=0)
    scale[scale == 0] = 1.0
    w = fit_nonneg(X / scale, y) / scale
    coeffs = {COEFF_OF[k]: float(w[i]) for i, k in enumerate(FEATURES)}
    coeffs["base_s"] = float(w[len(FEATURES)])

    pred = np.array([predict_s(f, coeffs) for _, _, f, _ in pts])
    roof = np.array([roofline_s(f) for _, _, f, _ in pts])
    rel_rms = float(np.sqrt(np.mean(((pred - y) / y) ** 2)))

    regimes = {}
    for (row, sched, f, wall), p, r in zip(pts, pred, roof):
        key = (row["mask_kind"], int(row["P"]), int(row["seq"]))
        regimes.setdefault(key, {})[sched] = (wall, float(p), float(r))
    agree = []
    for (mk_, P, seq), by_sched in sorted(regimes.items()):
        agree.append(dict(
            mask_kind=mk_, P=P, seq=seq,
            measured_best=min(by_sched, key=lambda s: by_sched[s][0]),
            calibrated_pick=min(by_sched, key=lambda s: by_sched[s][1]),
            roofline_pick=min(by_sched, key=lambda s: by_sched[s][2])))
    n_cal = sum(a["calibrated_pick"] == a["measured_best"] for a in agree)
    n_roof = sum(a["roofline_pick"] == a["measured_best"] for a in agree)
    return dict(
        coeffs=coeffs,
        fit=dict(n_points=len(pts), rel_rms=round(rel_rms, 4),
                 spearman=round(spearman(pred, y), 4),
                 spearman_roofline=round(spearman(roof, y), 4),
                 best_match=f"{n_cal}/{len(agree)}",
                 best_match_roofline=f"{n_roof}/{len(agree)}",
                 regimes=agree))

"""The port's schedule plans equal the reference's, in process (no world).

``build_plan`` of ``ring``, ``balanced`` and ``zigzag`` for P ∈ {2, 3, 4, 5,
8} under causal, sliding-window (several widths), document-with-boundaries
and (ring only) full masks: every Step, Work, Operand, Route and MaskSpec
field equal to the reference's.  ``plan_coverage`` and ``global_allow``
return the reference's arrays, and every plan computes each allowed global
(q, kv) pair exactly once.  The per-step mask helpers equal the
reference's.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import mask as rmk
from repro.core import schedule as rsp
from repro_torch.core import mask as tmk
from repro_torch.core import schedule as tsp

TL = 16
PS = [2, 3, 4, 5, 8]
WINDOWS = [3, 16, 40, 100]


def _masks(pkg, sched, P):
    T = P * TL
    out = [("causal", pkg.causal())]
    out += [(f"window{w}", pkg.sliding_window(w)) for w in WINDOWS]
    out.append(("boundaries", pkg.document(
        boundaries=pkg.doc_boundaries(T, 4))))
    out.append(("boundaries-window", pkg.document(
        boundaries=pkg.doc_boundaries(T, 3), window=20)))
    if sched == "ring":
        out.append(("full", pkg.full()))
    return out


def _fields(x):
    """A plan as nested tuples of plain values (MaskSpecs by fields)."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(
            (f.name, _fields(getattr(x, f.name)))
            for f in dataclasses.fields(x))
    if isinstance(x, (tuple, list)):
        return tuple(_fields(v) for v in x)
    return x


@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("sched", ["ring", "balanced", "zigzag"])
def test_plans_equal_reference_field_by_field(sched, P):
    for (name, rm), (_, tm) in zip(_masks(rmk, sched, P),
                                   _masks(tmk, sched, P)):
        rp = rsp.build_plan(sched, rm, P, TL)
        tp = tsp.build_plan(sched, tm, P, TL)
        assert _fields(tp) == _fields(rp), (sched, P, name)
        assert (tp.exec_steps, tp.skipped_steps, tp.kernel_calls,
                tp.ship_q, tp.uses_ring) == (
            rp.exec_steps, rp.skipped_steps, rp.kernel_calls, rp.ship_q,
            rp.uses_ring)


@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("sched", ["ring", "balanced", "zigzag"])
def test_coverage_and_global_allow_equal_reference(sched, P):
    T = P * TL
    for (name, rm), (_, tm) in zip(_masks(rmk, sched, P),
                                   _masks(tmk, sched, P)):
        tp = tsp.build_plan(sched, tm, P, TL)
        cov = tsp.plan_coverage(tp)
        truth = tsp.global_allow(tm, T)
        np.testing.assert_array_equal(
            cov, rsp.plan_coverage(rsp.build_plan(sched, rm, P, TL)))
        np.testing.assert_array_equal(truth, rsp.global_allow(rm, T))
        # exactly once on the allowed pairs, never elsewhere
        np.testing.assert_array_equal(cov, truth.astype(np.int64))


@pytest.mark.parametrize("sched", ["ring", "balanced", "zigzag"])
def test_dynamic_segment_coverage_equals_reference(sched):
    P = 4
    T = P * TL
    seg = tmk.segments_from_boundaries(T, tmk.doc_boundaries(T, 5))
    tp = tsp.build_plan(sched, tmk.document(), P, TL)
    rp = rsp.build_plan(sched, rmk.document(), P, TL)
    cov = tsp.plan_coverage(tp, segments=seg)
    np.testing.assert_array_equal(cov, rsp.plan_coverage(rp, segments=seg))
    np.testing.assert_array_equal(
        cov, tsp.global_allow(tmk.document(), T, segments=seg))


def test_step_mask_helpers_equal_reference():
    specs = [("causal",), ("sliding_window", 7), ("document",),
             ("document_window",)]

    def build(pkg, s):
        if s[0] == "document":
            return pkg.document(boundaries=(0, 5, 19, 40))
        if s[0] == "document_window":
            return pkg.document(window=9)
        return getattr(pkg, s[0])(*s[1:])

    for s in specs:
        rm, tm = build(rmk, s), build(tmk, s)
        for fn in ("strict_causal_pair", "offdiag_step"):
            assert _fields(getattr(tmk, fn)(tm)) == \
                _fields(getattr(rmk, fn)(rm))
        for rel in (1, 16, 48):
            assert _fields(tmk.ring_step(tm, rel)) == \
                _fields(rmk.ring_step(rm, rel))
        rng = np.random.default_rng(len(s[0]))
        for _ in range(200):
            q_lo, k_lo = (int(x) for x in rng.integers(0, 60, 2))
            q_hi = q_lo + int(rng.integers(0, 20))
            k_hi = k_lo + int(rng.integers(0, 20))
            assert tmk.chunk_pair_needed(tm, q_lo, q_hi, k_lo, k_hi) == \
                rmk.chunk_pair_needed(rm, q_lo, q_hi, k_lo, k_hi)


@pytest.mark.parametrize("sched", ["ring", "balanced", "zigzag"])
def test_rank_launch_counts_follow_the_routes(sched):
    """A rank launches the Work items with a route that reaches an output
    on it: every item has such a rank, the fused balanced step keeps every
    rank busy (except the helper-free last step of an even P), and under
    ring rank p idles at steps t > p."""
    for P in PS:
        plan = tsp.build_plan(sched, tmk.causal(), P, TL)
        per_rank = [plan.kernel_calls_on(p) for p in range(P)]
        for s in plan.steps:
            for w in s.work:
                assert any(tsp.work_active(w, P, p) for p in range(P))
        if sched == "ring":
            assert per_rank == [1 + p for p in range(P)]
        if sched == "balanced":
            T = P // 2
            want = [1 + T - (p < T and P % 2 == 0) for p in range(P)]
            assert per_rank == want
        if sched == "zigzag":
            assert per_rank == [plan.kernel_calls] * P
        assert [plan.kernel_calls_on(p, backward=True)
                for p in range(P)] == per_rank


@pytest.mark.parametrize("sched", ["ring", "balanced", "zigzag"])
def test_rank_calls_walk_the_executors_launches(sched):
    """``rank_calls`` yields, per step and rank, exactly the items the
    executors launch, with ``work_operands``' chunks and masks; and the
    coverage rule (``route_reaches``) picks the same items on every rank
    as the executors' ``work_active``, forward and backward."""
    for P in PS:
        for name, m in _masks(tmk, sched, P):
            plan = tsp.build_plan(sched, m, P, TL)
            for backward in (False, True):
                calls = list(tsp.rank_calls(plan, backward))
                assert [sum(c[1] == p for c in calls) for p in range(P)] \
                    == [plan.kernel_calls_on(p, backward) for p in range(P)]
                want, d = [], 0
                for si, step in enumerate(plan.steps):
                    d += step.shift
                    for p in range(P):
                        for w in step.work:
                            reach = any(tsp.route_reaches(r, P, p)
                                        for r in w.routes)
                            assert reach == tsp.work_active(
                                w, P, p, backward), (name, P, si, p)
                            if reach:
                                want.append((si, p) + tsp.work_operands(
                                    plan, w, p, d))
                assert [c[:4] + (_fields(c[4]),) for c in calls] == \
                    [c[:4] + (_fields(c[4]),) for c in want], (name, P)


def test_build_plan_refuses_unknown_and_odd_zigzag():
    with pytest.raises(ValueError, match="no plan builder"):
        tsp.build_plan("ulysses", tmk.causal(), 4, TL)
    with pytest.raises(ValueError, match="even local shard"):
        tsp.build_plan("zigzag", tmk.causal(), 4, 15)

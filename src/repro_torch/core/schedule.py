"""Schedule-plan IR: one step engine for every distributed-attention
schedule (port of the reference ``core/schedule.py``: the IR, the
ring / balanced / zigzag builders, the two executors, the coverage
simulator, the capability rules, the 2D sequence × head plans —
:class:`Plan2D`, :func:`build_plan2d` and the executors
:func:`execute2d_fwd` / :func:`execute2d_bwd` on a 2-D grid of groups —
and the static cost model that ``schedule="auto"`` ranks by:
:class:`PlanCost`, :func:`plan_cost`, :func:`ulysses_cost`,
:func:`plan2d_cost`, :func:`choose_schedule` and
:func:`choose_inner_schedule`).

DISTFLASHATTN's schedules differ only in *placement and per-step routing*:
which (q-chunk, kv-chunk) pair each rank computes at each ring step, and
where the partial result or its gradients are merged.  That structure is
static, so each schedule is a declarative :class:`SchedulePlan`, and one
forward executor (:func:`execute_fwd`) and one backward executor
(:func:`execute_bwd`) run any plan.

The IR
------
* :class:`Ref` — one operand chunk: ``src`` ∈ ``local`` (this rank's shard)
  | ``ring`` (the traveling KV container) | ``bundle`` (the traveling query
  bundle of the balanced schedule); ``chunk`` indexes the shard's
  ``n_chunks`` sub-chunks (zigzag holds two).
* :class:`Operand` — a Ref, optionally predicate-selected against an
  alternative (the balanced schedule's worker/helper fusion: one kernel a
  step, whichever role the rank plays).
* :class:`Route` — where one kernel result goes: merged into a local output
  chunk where a rank predicate holds, optionally after a ``ship`` shift
  (the balanced helper sending ``(o, lse)`` home).
* :class:`Work` — one chunk-attention kernel call: operands, the step's
  static MaskSpec, routes, and whether the mask's chunk distance depends on
  the rank (``dyn_offsets``: zigzag window bands).
* :class:`Step` — the Work items of one ring step plus the ``shift`` (hops
  since the previous executed step; > 1 when skipped steps were folded in).

The builders are pure Python over static ints and import no tensors; they
prove per step, by enumerating the P ranks, whether any rank has an
unmasked pair (:func:`~repro_torch.core.mask.chunk_pair_needed`) and drop
provably all-masked items and steps.  :func:`plan_coverage` walks the
executor's routing in numpy (each global (q, kv) pair computed exactly
once; see :func:`global_allow`).

The executors run on each rank of a ``torch.distributed`` group
(:class:`~repro_torch.parallel.comm.Comm`).  The rank index ``p`` is a
Python int, so every predicate resolves on the host: a fused operand picks
one branch and launches one kernel, a rank none of whose routes hold for a
Work item launches nothing for it (the reference's SPMD program computes
and discards it), and zigzag's rank-dependent offsets are plain integers
folded into a static mask.  KV communication overlaps compute as in the
paper: the shift that brings step t + 1's data is issued before step t's
kernels and waited on after them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import mask as mk
from repro_torch.core.attention import (chunk_attn, chunk_attn_bwd,
                                        empty_partial, merge)
from repro_torch.core.mask import MaskSpec
from repro_torch.parallel.comm import all_to_all

# ---------------------------------------------------------------------------
# Predicates on the rank index p — static tuples
# ---------------------------------------------------------------------------

ALWAYS = ("always",)


def _ge(t):
    return ("ge", int(t))


def _lt(t):
    return ("lt", int(t))


def _neg(pred):
    if pred == ALWAYS:
        return ("never",)
    kind, t = pred
    return ("lt", t) if kind == "ge" else ("ge", t)


def _pred_int(pred, p: int) -> bool:
    """``pred`` at rank ``p``."""
    if pred == ALWAYS:
        return True
    kind, t = pred
    if kind == "never":
        return False
    return (p >= t) if kind == "ge" else (p < t)


# ---------------------------------------------------------------------------
# IR dataclasses
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Ref:
    """One operand chunk: which container, which sub-chunk."""
    src: str                        # "local" | "ring" | "bundle"
    chunk: int = 0                  # sub-chunk index (< plan.n_chunks)


@dataclasses.dataclass(frozen=True)
class Operand:
    """A Ref, optionally predicate-selected against an alternative: ranks
    where ``pred`` holds use ``ref``, others use ``alt``."""
    ref: Ref
    alt: Optional[Ref] = None
    pred: Tuple = ALWAYS


@dataclasses.dataclass(frozen=True)
class Route:
    """Routing of one kernel result: merge into local output ``chunk``
    where ``pred`` holds; ``ship`` != 0 first shifts the raw (o, lse) by
    that many hops and gates the merge with ``recv_pred`` on the receiving
    rank (the balanced helper send-home)."""
    pred: Tuple = ALWAYS
    chunk: int = 0
    ship: int = 0
    recv_pred: Tuple = ALWAYS


@dataclasses.dataclass(frozen=True)
class Work:
    """One chunk-attention kernel call and its result routing.
    ``dyn_offsets`` marks masks whose chunk distance depends on the rank:
    the executor folds the rank's absolute q/kv chunk offsets into the
    mask (zigzag window bands)."""
    q: Operand
    kv: Operand
    mask: MaskSpec
    routes: Tuple[Route, ...]
    dyn_offsets: bool = False


@dataclasses.dataclass(frozen=True)
class Step:
    """Ring step: advance the traveling containers by ``shift`` hops (> 1
    when skipped steps were folded in), then run ``work``."""
    shift: int
    work: Tuple[Work, ...]


@dataclasses.dataclass(frozen=True)
class SchedulePlan:
    """Static description of one distributed-attention schedule.
    ``steps[0]`` is the local step (shift 0); ``mask`` is the global
    MaskSpec (it may carry static ``boundaries``; work masks are always
    boundary-stripped, and the executor derives per-shard segment arrays
    instead)."""
    name: str
    P: int
    Tl: int                          # local shard length (tokens)
    n_chunks: int                    # local shard viewed as n sub-chunks
    layout: str                      # "natural" | "zigzag"
    mask: MaskSpec
    steps: Tuple[Step, ...]
    total_steps: int                 # ring steps before static skipping

    @property
    def chunk_len(self) -> int:
        return self.Tl // self.n_chunks

    @property
    def exec_steps(self) -> int:
        """Ring steps actually executed (local step excluded)."""
        return len(self.steps) - 1

    @property
    def skipped_steps(self) -> int:
        return self.total_steps - self.exec_steps

    @property
    def kernel_calls(self) -> int:
        return sum(len(s.work) for s in self.steps)

    def kernel_calls_on(self, p: int, backward: bool = False) -> int:
        """Kernel launches rank ``p`` makes in one pass: the Work items
        with a route that holds on ``p`` (see :func:`work_active`)."""
        return sum(work_active(w, self.P, p, backward)
                   for s in self.steps for w in s.work)

    def _uses(self, src: str) -> bool:
        for s in self.steps:
            for w in s.work:
                for op in (w.q, w.kv):
                    if op.ref.src == src or (op.alt and op.alt.src == src):
                        return True
        return False

    @property
    def ship_q(self) -> bool:
        """A query bundle travels the ring (balanced helpers)."""
        return self._uses("bundle")

    @property
    def uses_ring(self) -> bool:
        return self._uses("ring")


def work_active(w: Work, P: int, p: int, backward: bool = False) -> bool:
    """Does rank ``p``'s result of ``w`` reach an output?  Forward: a local
    route whose ``pred`` holds on ``p``, or a shipped one whose
    ``recv_pred`` holds on the receiver (the executor's merge gates).
    Backward: a route whose ``pred`` holds on ``p`` (the gradient
    weights).  An inactive item launches no kernel."""
    for r in w.routes:
        if backward or not r.ship:
            if _pred_int(r.pred, p):
                return True
        elif _pred_int(r.recv_pred, (p + r.ship) % P):
            return True
    return False


# ---------------------------------------------------------------------------
# Plan builders
# ---------------------------------------------------------------------------

PLAN_SCHEDULES = ("ring", "balanced", "zigzag")

_L0 = Operand(Ref("local", 0))
_L1 = Operand(Ref("local", 1))
_R0 = Operand(Ref("ring", 0))
_R1 = Operand(Ref("ring", 1))
_B0 = Operand(Ref("bundle", 0))


def _exec_mask(m: MaskSpec) -> MaskSpec:
    """Kernel-facing variant of the global mask: static ``boundaries`` are
    absolute coordinates the per-shard kernels can't see, so they are
    stripped (the executor derives per-shard segment arrays instead)."""
    return m.replace(boundaries=None) if m.boundaries is not None else m


def _any_pair(m: MaskSpec, c: int, pairs) -> bool:
    """Does any rank's (q-chunk, kv-chunk) global-index pair have a
    possibly-unmasked position pair?  Chunks span ``c`` tokens."""
    return any(mk.chunk_pair_needed(m, qg * c, (qg + 1) * c - 1,
                                    kg * c, (kg + 1) * c - 1)
               for qg, kg in pairs)


def _assemble(name, m, P, Tl, n_chunks, layout, local_work, executed,
              total_steps) -> SchedulePlan:
    """Fold the executed (t, works) list into Steps with cumulative shifts
    over skipped ring steps."""
    steps = [Step(0, tuple(local_work))]
    prev = 0
    for t, works in executed:
        steps.append(Step(t - prev, tuple(works)))
        prev = t
    return SchedulePlan(name=name, P=P, Tl=Tl, n_chunks=n_chunks,
                        layout=layout, mask=m, steps=tuple(steps),
                        total_steps=total_steps)


def _ring_plan(m: MaskSpec, P: int, Tl: int) -> SchedulePlan:
    """Vanilla ring (paper Alg. 1): P−1 steps, rank p computes
    (q_p × kv_{p−t}); under a causal mask ranks p < t idle.  Sliding windows
    truncate the tail; static document boundaries prune steps no document
    spans."""
    me = _exec_mask(m)
    local = [Work(_L0, _L0, me, (Route(),))]
    executed = []
    for t in range(1, P):
        devs = range(t, P) if m.causal else range(P)
        if not _any_pair(m, Tl, [(p, (p - t) % P) for p in devs]):
            continue
        pred = _ge(t) if m.causal else ALWAYS
        executed.append((t, [Work(_L0, _R0, mk.ring_step(me, t * Tl),
                                  (Route(pred=pred),))]))
    return _assemble("ring", m, P, Tl, 1, "natural", local, executed, P - 1)


def _balanced_plan(m: MaskSpec, P: int, Tl: int) -> SchedulePlan:
    """Load-balanced schedule (paper Alg. 2): ⌊P/2⌋ steps; workers with
    causal work left compute (q_p × kv_{p−t}) while helpers compute
    (q_{(p−t) mod P} × kv_p) for distance-(P−t) pairs and ship (o, lse)
    home.  Plain causal (± dynamic document) fuses both roles into one
    predicate-selected kernel per step, as the paper's implementation does;
    windowed / boundary-pruned variants split into separately skippable
    worker and helper items."""
    me = _exec_mask(m)
    local = [Work(_L0, _L0, me, (Route(),))]
    T = P // 2
    fused = m.window == 0 and m.boundaries is None
    executed = []
    for t in range(1, T + 1):
        helpers = (t != T) or (P % 2 == 1)
        if fused:
            routes = [Route(pred=_ge(t))]
            if helpers:
                routes.append(Route(pred=_lt(t), ship=-t,
                                    recv_pred=_ge(P - t)))
            executed.append((t, [Work(
                Operand(Ref("local", 0), Ref("bundle", 0), _ge(t)),
                Operand(Ref("ring", 0), Ref("local", 0), _ge(t)),
                mk.strict_causal_pair(me), tuple(routes))]))
            continue
        works = []
        if _any_pair(m, Tl, [(p, p - t) for p in range(t, P)]):
            works.append(Work(_L0, _R0, mk.ring_step(me, t * Tl),
                              (Route(pred=_ge(t)),)))
        if helpers and _any_pair(m, Tl, [(p + P - t, p) for p in range(t)]):
            works.append(Work(_B0, _L0, mk.ring_step(me, (P - t) * Tl),
                              (Route(pred=_lt(t), ship=-t,
                                     recv_pred=_ge(P - t)),)))
        if works:
            executed.append((t, works))
    return _assemble("balanced", m, P, Tl, 1, "natural", local, executed, T)


def _zigzag_plan(m: MaskSpec, P: int, Tl: int) -> SchedulePlan:
    """Zigzag placement: 2P half-chunks, rank p holds (p, 2P−1−p); exact
    balance with only the KV ring.  At step t the received container holds
    chunks (r, 2P−1−r) of r = (p−t) mod P and each rank computes two
    strictly-causal pairs.  Mirror-chunk pair distances depend on the rank,
    so windowed variants use rank-offset masks, and skipping carves out the
    middle steps."""
    if Tl % 2:
        raise ValueError(f"zigzag needs an even local shard length, "
                         f"got {Tl}")
    c = Tl // 2
    G = 2 * P

    def gl(p, i):                      # global half-chunk of (rank, slot)
        return p if i == 0 else G - 1 - p

    me = _exec_mask(m)
    m_x = mk.strict_causal_pair(me)
    m_dyn = mk.offdiag_step(me)
    win = m.window > 0
    local = [Work(_L0, _L0, me, (Route(chunk=0),))]
    if _any_pair(m, c, [(gl(p, 1), gl(p, 0)) for p in range(P)]):
        local.append(Work(_L1, _L0, m_dyn if win else m_x,
                          (Route(chunk=1),), dyn_offsets=win))
    local.append(Work(_L1, _L1, me, (Route(chunk=1),)))
    fused = m.window == 0 and m.boundaries is None
    executed = []
    for t in range(1, P):
        if fused:
            w1 = Work(Operand(Ref("local", 0), Ref("local", 1), _ge(t)),
                      _R0, m_x,
                      (Route(pred=_ge(t), chunk=0),
                       Route(pred=_lt(t), chunk=1)))
            w2 = Work(_L1,
                      Operand(Ref("ring", 0), Ref("ring", 1), _ge(t)),
                      m_x, (Route(chunk=1),))
            executed.append((t, [w1, w2]))
            continue
        works = []
        # worker a×a_r — static distance t
        if _any_pair(m, c, [(p, p - t) for p in range(t, P)]):
            works.append(Work(_L0, _R0, mk.ring_step(me, t * c),
                              (Route(pred=_ge(t), chunk=0),)))
        # b̄×a_r — rank-dependent distances; one kernel call serves both
        # branches, so when both survive pruning they fuse into one
        # always-routed Work
        need_h = _any_pair(m, c, [(gl(p, 1), p + P - t) for p in range(t)])
        need_w = _any_pair(m, c, [(gl(p, 1), p - t) for p in range(t, P)])
        if need_h or need_w:
            pred = ALWAYS if (need_h and need_w) else \
                (_lt(t) if need_h else _ge(t))
            works.append(Work(_L1, _R0, m_dyn,
                              (Route(pred=pred, chunk=1),),
                              dyn_offsets=True))
        # helper b̄×b̄_r — static distance P−t
        if _any_pair(m, c, [(gl(p, 1), gl(p + P - t, 1))
                            for p in range(t)]):
            works.append(Work(_L1, _R1, mk.ring_step(me, (P - t) * c),
                              (Route(pred=_lt(t), chunk=1),)))
        if works:
            executed.append((t, works))
    return _assemble("zigzag", m, P, Tl, 2, "zigzag", local, executed,
                     P - 1)


_BUILDERS = {"ring": _ring_plan, "balanced": _balanced_plan,
             "zigzag": _zigzag_plan}


def build_plan(schedule: str, mask: MaskSpec, P: int, Tl: int) \
        -> SchedulePlan:
    """The SchedulePlan of one schedule × mask × P × shard length."""
    if schedule not in _BUILDERS:
        raise ValueError(f"no plan builder for schedule {schedule!r}; "
                         f"plan schedules: {PLAN_SCHEDULES}")
    return _BUILDERS[schedule](mask, P, Tl)


def plan_capable(schedule: str, mask: MaskSpec) -> bool:
    """Can this plan schedule serve the mask?  (prefix_lm needs absolute
    kv positions on every chunk — ulysses/rsa territory; balanced/zigzag
    additionally need a causal-kind mask for their strictly-causal pair
    placement.  A *non-causal* sliding window needs future-direction band
    steps the ring's strictly-past step masks can't express — ulysses
    only.)"""
    if mask.prefix_len:
        return False
    if mask.window and not mask.causal:
        return False
    if schedule in ("balanced", "zigzag"):
        return bool(mask.causal)
    return schedule == "ring"


def ulysses_capable(mask: MaskSpec, P: int, Hq: int, Hkv: int, *,
                    include_bwd: bool = True) -> bool:
    """Can the ulysses baseline serve this call without raising at
    execution time?  Forward needs both head counts divisible by P; a
    backward additionally rules out prefix_lm and non-causal sliding
    windows, because the baselines reuse the ring backward, whose
    per-shard chunks cannot see absolute positions / future-direction
    bands."""
    if Hq % P or Hkv % P:
        return False
    if include_bwd and mask.prefix_len:
        return False
    if include_bwd and mask.window and not mask.causal:
        return False
    return True


# ---------------------------------------------------------------------------
# 2D sequence × head (ring × ulysses) factored plans
# ---------------------------------------------------------------------------
#
# The P sequence-parallel ranks form a (seq = r) × (head = u) grid, P = r·u,
# and the global sequence is sharded over the pair (seq major, head minor).
# An all-to-all over the head sub-axis — DeepSpeed-Ulysses' head scatter —
# leaves each rank a contiguous T/r sequence shard of Hq/u query heads; any
# ring-family SchedulePlan then runs unchanged over the seq sub-axis, and
# the results travel home through the inverse all-to-all.  GQA-aware: query
# heads always scatter; KV heads scatter when ``Hkv % u == 0`` and are
# otherwise all-gathered over the head sub-axis, each rank selecting the KV
# heads its query heads read (the inner plan is then locally MHA).

PLAN2D_SCHEDULES = PLAN_SCHEDULES


@dataclasses.dataclass(frozen=True)
class Plan2D:
    """A factored 2D schedule: head scatter over ``u`` ranks wrapping the
    ``inner`` ring-family plan over ``r`` ranks (``inner.P == r``,
    ``inner.Tl == u · Tl_dev``).  ``Hq`` / ``Hkv`` are the global head
    counts; ``kv_mode`` is ``"scatter"`` or ``"replicate"``."""
    inner: SchedulePlan
    r: int
    u: int
    Hq: int
    Hkv: int
    kv_mode: str

    @property
    def name(self) -> str:
        return f"{self.inner.name}@r{self.r}u{self.u}"

    @property
    def P(self) -> int:
        return self.r * self.u


def plan2d_capable(schedule: str, mask: MaskSpec, *, r: int, u: int,
                   Hq: int, Hkv: int) -> bool:
    """Can the (schedule, r, u) factorization serve this mask × head
    shape?  Query heads must split evenly over the head sub-axis and the
    GQA groups must be uniform; the inner schedule follows
    :func:`plan_capable` — except at r == 1, where the ring is one local
    full-sequence kernel after the head scatter, which serves any mask
    (prefix_lm and non-causal windows included)."""
    if schedule not in PLAN2D_SCHEDULES:
        return False
    if Hq % u or Hq % Hkv:
        return False
    if r == 1:
        return schedule == "ring"
    return plan_capable(schedule, mask)


def build_plan2d(schedule: str, mask: MaskSpec, r: int, u: int,
                 Tl_dev: int, *, Hq: int, Hkv: int) -> Plan2D:
    """The 2D plan of one factorization: the inner seq-axis plan at P = r
    over the post-scatter shard length u·Tl_dev, and the KV heads' mode."""
    if not plan2d_capable(schedule, mask, r=r, u=u, Hq=Hq, Hkv=Hkv):
        raise ValueError(
            f"2D factorization (schedule={schedule!r}, r={r}, u={u}) "
            f"cannot serve mask {mask.kind!r} with heads ({Hq}, {Hkv}) — "
            f"query heads must divide u and the inner schedule must be "
            f"plan-capable for the mask (any mask goes at r == 1)")
    inner = build_plan(schedule, mask, r, u * Tl_dev)
    kv_mode = "scatter" if Hkv % u == 0 else "replicate"
    return Plan2D(inner=inner, r=r, u=u, Hq=Hq, Hkv=Hkv, kv_mode=kv_mode)


def plan2d_head_map(p2: Plan2D, j: int):
    """Head routing of head-rank ``j``: ``(q_ids, kv_ids)``, the global
    head indices of its local slots after the scatter.  Scatter mode: the
    rank's all-to-all share of KV heads; replicate mode: the selection
    ``(global q head) // g``, one KV slot per query slot."""
    Hql = p2.Hq // p2.u
    q_ids = np.arange(j * Hql, (j + 1) * Hql)
    if p2.kv_mode == "scatter":
        Hkvl = p2.Hkv // p2.u
        kv_ids = np.arange(j * Hkvl, (j + 1) * Hkvl)
    else:
        kv_ids = (j * Hql + np.arange(Hql)) // (p2.Hq // p2.Hkv)
    return q_ids, kv_ids


# ---------------------------------------------------------------------------
# Shared executor machinery
# ---------------------------------------------------------------------------

def _gchunk(layout, P, owner, i):
    """Global chunk index of (owner rank, local sub-chunk i)."""
    if layout == "zigzag" and i == 1:
        return 2 * P - 1 - owner
    return owner


def _flat(data: dict):
    """A container dict of tensors / tuples of tensors as (list, keys)."""
    keys, out = [], []
    for name in sorted(data):
        val = data[name]
        if torch.is_tensor(val):
            keys.append((name, None))
            out.append(val)
        else:
            keys.append((name, len(val)))
            out.extend(val)
    return out, keys


def _unflat(ts, keys) -> dict:
    data, i = {}, 0
    for name, n in keys:
        if n is None:
            data[name] = ts[i]
            i += 1
        else:
            data[name] = tuple(ts[i:i + n])
            i += n
    return data


def _shift(comm, data: dict, hops: int):
    """Issue the shift of a container dict: rank p receives from
    (p − hops) mod P.  Returns a handle whose ``wait()`` gives the dict."""
    ts, keys = _flat(data)
    pending = comm.shift(ts, hops)
    return _Pending(pending, keys)


def _shift_now(comm, data: dict, hops: int) -> dict:
    """A shift waited on at once (the backward's accumulators)."""
    ts, keys = _flat(data)
    return _unflat(comm.shift(ts, hops).wait(), keys)


class _Pending:
    def __init__(self, pending, keys):
        self.pending, self.keys = pending, keys

    def wait(self) -> dict:
        return _unflat(self.pending.wait(), self.keys)


class _Ctx:
    """Per-call executor state: local shards, the traveling containers at
    the current ring distance, and the static plan."""

    def __init__(self, plan, comm, tune, q, k, v, seg, latent=None):
        if comm.size != plan.P:
            raise ValueError(f"plan for P={plan.P} on a group of "
                             f"{comm.size} ranks")
        self.plan, self.comm, self.tune = plan, comm, tune
        self.P = plan.P
        self.p = comm.rank
        self.nc = plan.n_chunks
        self.c = q.shape[1] // self.nc
        self.B = q.shape[0]
        self.q, self.k, self.v, self.seg = q, k, v, seg
        self.latent = latent                  # (payload, w_up, expand)
        m = plan.mask
        self.doc = m.document
        self.derive_seg = (m.document and seg is None
                           and m.boundaries is not None)
        self.d = 0                            # current ring distance
        self.ring_kv = None                   # (k, v) at distance d
        self.ring_seg = None
        self.bundle = None                    # fwd: (q,); bwd: (q, do, lse, Δ)

    def cut(self, x, i):
        return x[:, i * self.c:(i + 1) * self.c]

    def seg_for(self, ref, g):
        """(B, c) int32 segment ids of a ref's chunk (global chunk ``g``),
        or None."""
        if not self.doc:
            return None
        if self.derive_seg:
            pos = g * self.c + torch.arange(self.c, device=self.q.device)
            row = self.plan.mask.segment_of(pos)
            return row[None, :].expand(self.B, self.c)
        if self.seg is None:
            return None
        arr = self.seg if ref.src == "local" else self.ring_seg
        return self.cut(arr, ref.chunk)

    def data_containers(self, bwd_bundle=None) -> dict:
        """The traveling data, built once before the first shift.
        ``bwd_bundle`` supplies (do, lse, delta) so the backward bundle
        carries the helper-side statistics next to q."""
        plan = self.plan
        data = {}
        if plan.uses_ring:
            data["kv"] = self.latent[0] if self.latent else (self.k, self.v)
        if plan.ship_q:
            data["bundle"] = (self.q,) if bwd_bundle is None \
                else (self.q,) + tuple(bwd_bundle)
        if self.doc and not self.derive_seg and self.seg is not None \
                and (plan.uses_ring or plan.ship_q):
            data["seg"] = self.seg
        return data

    def install(self, data: dict):
        """Point the ctx at a (shifted) container dict; a latent payload
        is expanded into the (k, v) it stands for on arrival."""
        if "kv" in data:
            if self.latent:
                _, w_up, expand = self.latent
                self.ring_kv = expand(data["kv"], w_up)
            else:
                self.ring_kv = data["kv"]
        self.ring_seg = data.get("seg")
        self.bundle = data.get("bundle")


def _pick(op: Operand, p: int) -> Ref:
    """The operand branch rank ``p`` uses."""
    if op.alt is None or _pred_int(op.pred, p):
        return op.ref
    return op.alt


def _call(ctx: _Ctx, w: Work, extras=()):
    """This rank's inputs of ``w``'s kernel: the q-side chunks (q and the
    statistics ``extras`` names, do / lse / delta in the backward, from the
    local arrays or the traveling bundle), the (k, v) chunks, and the
    kernel's keyword arguments (its mask, with rank offsets folded in,
    and segment ids)."""
    p = ctx.p
    qref, kref = _pick(w.q, p), _pick(w.kv, p)
    qg, kg, mask = work_operands(ctx.plan, w, p, ctx.d)
    src = (ctx.q,) + tuple(extras) if qref.src == "local" else ctx.bundle
    qs = [ctx.cut(x, qref.chunk) for x in src]
    kk, vv = (ctx.k, ctx.v) if kref.src == "local" else ctx.ring_kv
    kw = dict(ctx.tune, mask=mask)
    q_seg = ctx.seg_for(qref, qg) if mask.document else None
    if q_seg is not None:
        kw.update(q_segments=q_seg, kv_segments=ctx.seg_for(kref, kg))
    return qs, (ctx.cut(kk, kref.chunk), ctx.cut(vv, kref.chunk)), kw


def _grad_branches(op: Operand, route_pred):
    """Which operand branch(es) a route's gradient flows to, with the
    predicates that gate each: [(preds, ref), ...]."""
    if op.alt is None or op.pred == ALWAYS:
        return [([route_pred], op.ref)]
    if op.pred == route_pred:
        return [([route_pred], op.ref)]
    if op.pred == _neg(route_pred):
        return [([route_pred], op.alt)]
    return [([route_pred, op.pred], op.ref),
            ([route_pred, _neg(op.pred)], op.alt)]


def _run_steps(plan, ctx, comm, run, data, after_shift=None):
    """The ring loop shared by both executors: the local step, then for
    each executed step its data arrives and ``run`` launches its work.
    Every shift is issued one step ahead (the first one before the local
    step), so it overlaps the previous step's kernels, and is waited on
    only when its step begins.  ``after_shift(s)`` runs when the
    containers advance by ``s`` hops after the first ring step."""
    rest = plan.steps[1:]
    nxt = _shift(comm, data, rest[0].shift) if rest else None
    run(plan.steps[0])
    for i, step in enumerate(rest):
        data = nxt.wait()
        ctx.d += step.shift
        ctx.install(data)
        if i and after_shift is not None:
            after_shift(step.shift)
        nxt = _shift(comm, data, rest[i + 1].shift) \
            if i + 1 < len(rest) else None          # prefetch (overlap)
        run(step)


# ---------------------------------------------------------------------------
# Forward executor
# ---------------------------------------------------------------------------

def execute_fwd(plan: SchedulePlan, q, k, v, seg=None, *, comm, tune,
                latent=None):
    """Run any SchedulePlan forward on this rank's shards; returns
    (o, lse).  ``comm`` is the sequence-parallel group
    (:class:`~repro_torch.parallel.comm.Comm`); ``tune`` the chunk
    kernels' keyword arguments (scale, impl).  ``latent=(payload, w_up,
    expand)`` ships ``payload`` (B, Tl, d_lat) on the KV ring in place of
    (k, v), and every rank expands what arrives, ``expand(payload, w_up)
    -> (k, v)`` (the MLA latent ring: recompute over communication)."""
    ctx = _Ctx(plan, comm, tune, q, k, v, seg, latent)
    p, P = ctx.p, plan.P
    acc = [None] * plan.n_chunks

    def run(step):
        for w in step.work:
            if work_active(w, P, p):
                (qc,), (kc, vc), kw = _call(ctx, w)
                o_t, s_t = chunk_attn(qc, kc, vc, **kw)
            elif any(r.ship for r in w.routes):
                # the receiver discards it, but the shift is collective
                o_t, s_t = empty_partial(ctx.cut(q, 0), v.shape[-1])
            else:
                continue
            for r in w.routes:
                if r.ship:
                    o_r, s_r = comm.shift([o_t, s_t], r.ship).wait()
                    on = _pred_int(r.recv_pred, p)
                else:
                    o_r, s_r = o_t, s_t
                    on = _pred_int(r.pred, p)
                if on:
                    acc[r.chunk] = (o_r, s_r) if acc[r.chunk] is None \
                        else merge(*acc[r.chunk], o_r, s_r)

    _run_steps(plan, ctx, comm, run, ctx.data_containers())
    outs = [a if a is not None else empty_partial(ctx.cut(q, i),
                                                  v.shape[-1])
            for i, a in enumerate(acc)]
    if plan.n_chunks == 1:
        return outs[0]
    return (torch.cat([o for o, _ in outs], dim=1),
            torch.cat([s for _, s in outs], dim=1))


# ---------------------------------------------------------------------------
# Backward executor
# ---------------------------------------------------------------------------

def execute_bwd(plan: SchedulePlan, q, k, v, o, lse, do, seg=None, *,
                comm, tune):
    """Run any SchedulePlan backward from the saved (o, lse): the FA2
    backward per Work item, gradients routed by operand source, traveling
    float32 accumulators shifted after each step and sent home with one
    multi-hop shift.  Returns (dq, dk, dv)."""
    f32 = torch.float32
    delta = (o.float() * do.float()).sum(dim=-1)              # (B, T, H)
    lse = lse.float()
    ctx = _Ctx(plan, comm, tune, q, k, v, seg)
    p, P = ctx.p, plan.P
    acc = {"dq": torch.zeros(q.shape, dtype=f32, device=q.device),
           "dk": torch.zeros(k.shape, dtype=f32, device=k.device),
           "dv": torch.zeros(v.shape, dtype=f32, device=v.device)}
    travel = {}                           # shifted with the containers
    if plan.uses_ring:
        travel["dkv"] = (torch.zeros(k.shape, dtype=f32, device=k.device),
                         torch.zeros(v.shape, dtype=f32, device=v.device))
    if plan.ship_q:
        travel["dqb"] = torch.zeros(q.shape, dtype=f32, device=q.device)

    def add(base, i, val):
        base[:, i * ctx.c:(i + 1) * ctx.c] += val.to(f32)

    def run(step):
        for w in step.work:
            if not work_active(w, P, p, backward=True):
                continue
            (qc, do_c, lse_c, dlt_c), (kc, vc), kw = _call(
                ctx, w, (do, lse, delta))
            dq_t, dk_t, dv_t = chunk_attn_bwd(
                qc, kc, vc, do_c.new_zeros(do_c.shape), lse_c, do_c,
                delta=dlt_c, **kw)
            for r in w.routes:
                for preds, ref in _grad_branches(w.q, r.pred):
                    if all(_pred_int(pr, p) for pr in preds):
                        add(acc["dq"] if ref.src == "local"
                            else travel["dqb"], ref.chunk, dq_t)
                for preds, ref in _grad_branches(w.kv, r.pred):
                    if all(_pred_int(pr, p) for pr in preds):
                        dk, dv = ((acc["dk"], acc["dv"])
                                  if ref.src == "local" else travel["dkv"])
                        add(dk, ref.chunk, dk_t)
                        add(dv, ref.chunk, dv_t)

    def move(hops):                       # accumulators move late
        if travel:
            travel.update(_shift_now(comm, travel, hops))

    _run_steps(plan, ctx, comm, run,
               ctx.data_containers(bwd_bundle=(do, lse, delta)), move)
    if ctx.d:
        move(-ctx.d)                      # route the accumulators home
    if "dkv" in travel:
        acc["dk"] += travel["dkv"][0]
        acc["dv"] += travel["dkv"][1]
    if "dqb" in travel:
        acc["dq"] += travel["dqb"]
    return (acc["dq"].to(q.dtype), acc["dk"].to(k.dtype),
            acc["dv"].to(v.dtype))


# ---------------------------------------------------------------------------
# 2D executors: head scatter, the inner plan over seq, home
# ---------------------------------------------------------------------------

def _a2a_heads(x, head):
    """Scatter heads, gather sequence: (B, Tc, H, ...) → (B, u·Tc, H/u,
    ...).  Concatenating the head group's parts in rank order rebuilds a
    contiguous stretch of the sequence, since the sequence is sharded seq
    major, head minor."""
    return all_to_all(head, x, split_dim=2, concat_dim=1)


def _a2a_seq(x, head):
    """The inverse: split the sequence, gather heads."""
    return all_to_all(head, x, split_dim=1, concat_dim=2)


def _scatter_heads(p2: Plan2D, q, k, v, seg, head):
    """This rank's shards in the inner plan's layout: (qh, kh, vh, segh,
    kv_ids).  ``kv_ids`` (replicate mode only, else None) is the global
    KV selection the backward scatters gradients back through."""
    qh = _a2a_heads(q, head)
    kv_ids = None
    if p2.kv_mode == "scatter":
        kh, vh = _a2a_heads(k, head), _a2a_heads(v, head)
    else:
        kv_ids = torch.as_tensor(plan2d_head_map(p2, head.rank)[1],
                                 device=k.device)
        kh = head.all_gather(k, dim=1).index_select(2, kv_ids)
        vh = head.all_gather(v, dim=1).index_select(2, kv_ids)
    segh = None if seg is None else head.all_gather(seg, dim=1)
    return qh, kh, vh, segh, kv_ids


def execute2d_fwd(p2: Plan2D, q, k, v, seg=None, *, seq, head, tune):
    """Run a 2D plan forward on this rank's shards: head scatter over
    ``head`` (the head sub-axis's Comm), the inner plan over ``seq``, the
    inverse scatter home.  Returns (o, lse) in the caller's (seq-major,
    head-minor) sharding."""
    qh, kh, vh, segh, _ = _scatter_heads(p2, q, k, v, seg, head)
    o_h, s_h = execute_fwd(p2.inner, qh, kh, vh, segh, comm=seq, tune=tune)
    return _a2a_seq(o_h, head), _a2a_seq(s_h, head)


def execute2d_bwd(p2: Plan2D, q, k, v, o, lse, do, seg=None, *, seq, head,
                  tune):
    """Run a 2D plan backward from the saved (o, lse): the operands
    scattered as in the forward, the inner plan's backward over ``seq``,
    then the gradients home — an all-to-all for dq (and dk / dv in scatter
    mode); in replicate mode each selected head's float32 KV gradient is
    added into the full head dimension, summed over ``head``, and each rank
    keeps its own token chunk."""
    qh, kh, vh, segh, kv_ids = _scatter_heads(p2, q, k, v, seg, head)
    oh, doh, lseh = (_a2a_heads(x, head) for x in (o, do, lse))
    dqh, dkh, dvh = execute_bwd(p2.inner, qh, kh, vh, oh, lseh, doh, segh,
                                comm=seq, tune=tune)
    dq = _a2a_seq(dqh, head)
    if p2.kv_mode == "scatter":
        return dq, _a2a_seq(dkh, head), _a2a_seq(dvh, head)
    B, Tc = k.shape[0], k.shape[1]
    j = head.rank

    def home(dx, x):
        full = torch.zeros((B, Tc * p2.u, p2.Hkv) + tuple(x.shape[3:]),
                           dtype=torch.float32, device=x.device)
        full.index_add_(2, kv_ids, dx.float())
        head.all_reduce_([full])
        return full[:, j * Tc:(j + 1) * Tc].to(x.dtype)

    return dq, home(dkh, k), home(dvh, v)


# ---------------------------------------------------------------------------
# Pure-python plan simulator (tests: exactly-once coverage)
# ---------------------------------------------------------------------------

def _sim_allow(w: Work, plan: SchedulePlan, qg, kg, c, segments):
    """Boolean (c, c) attend matrix as the kernel computes it for this work
    item: static mask offsets, plus the true global offsets when
    ``dyn_offsets``, plus segment ids (given or boundary-derived)."""
    m = w.mask
    q_pos = m.q_offset + (qg * c if w.dyn_offsets else 0) + np.arange(c)
    k_pos = m.kv_offset + (kg * c if w.dyn_offsets else 0) + np.arange(c)
    qs = ks = None
    if m.document:
        if segments is not None:
            qs = np.asarray(segments)[qg * c:(qg + 1) * c][:, None]
            ks = np.asarray(segments)[kg * c:(kg + 1) * c][None, :]
        elif plan.mask.boundaries is not None:
            gb = plan.mask
            qs = np.array([gb.segment_index(qg * c + i)
                           for i in range(c)])[:, None]
            ks = np.array([gb.segment_index(kg * c + j)
                           for j in range(c)])[None, :]
    allow = m.allow(q_pos[:, None], k_pos[None, :], qs, ks)
    if allow is None:
        return np.ones((c, c), bool)
    return np.asarray(allow)


def work_operands(plan: SchedulePlan, w: Work, p: int, d: int):
    """(global q chunk, global kv chunk, kernel mask) of rank ``p``'s call
    of ``w`` at ring distance ``d``: the chunks its executor slices (in
    the plan's layout, ``chunk_len`` tokens each) and the mask with the
    rank's offsets folded in where ``dyn_offsets``."""
    qref, kref = _pick(w.q, p), _pick(w.kv, p)
    P = plan.P
    q_owner = p if qref.src == "local" else (p - d) % P
    k_owner = p if kref.src == "local" else (p - d) % P
    qg = _gchunk(plan.layout, P, q_owner, qref.chunk)
    kg = _gchunk(plan.layout, P, k_owner, kref.chunk)
    m = w.mask
    if w.dyn_offsets:
        c = plan.chunk_len
        m = mk.fold_offsets(m, qg * c, kg * c)
    return qg, kg, m


def rank_calls(plan: SchedulePlan, backward: bool = False):
    """Every kernel call of one pass of ``plan`` over its P ranks, step by
    step: ``(step index, rank, global q chunk, global kv chunk, kernel
    mask)`` of each Work item the executor launches on that rank
    (:func:`work_active`; ``backward`` for :func:`execute_bwd`'s)."""
    d = 0
    for si, step in enumerate(plan.steps):
        d += step.shift
        for p in range(plan.P):
            for w in step.work:
                if work_active(w, plan.P, p, backward):
                    yield (si, p) + work_operands(plan, w, p, d)


def route_reaches(r: Route, P: int, p: int) -> bool:
    """Does rank ``p``'s result, sent along route ``r``, reach an output?
    A local route where ``pred`` holds on ``p``; a shipped one where
    ``pred`` holds on ``p`` and ``recv_pred`` on the receiver (the rule of
    :func:`plan_coverage`, written apart from :func:`work_active`)."""
    if r.ship:
        return _pred_int(r.pred, p) and _pred_int(r.recv_pred,
                                                  (p + r.ship) % P)
    return _pred_int(r.pred, p)


def plan_coverage(plan: SchedulePlan, c: Optional[int] = None,
                  segments=None) -> np.ndarray:
    """(T, T) count of how many times each global (q, kv) token pair is
    computed and merged by the plan: a pure-python walk of the executor's
    routing.  ``c`` overrides tokens per sub-chunk; ``segments`` is an
    optional (T,) global segment-id array for dynamic document masks.
    Counts must equal 1 on :func:`global_allow`'s pairs and 0 elsewhere."""
    P, nc = plan.P, plan.n_chunks
    c = plan.chunk_len if c is None else c
    T = P * nc * c
    counts = np.zeros((T, T), np.int64)
    for p in range(P):
        d = 0
        for step in plan.steps:
            d += step.shift
            for w in step.work:
                qg, kg, _ = work_operands(plan, w, p, d)
                for r in w.routes:
                    if not route_reaches(r, P, p):
                        continue
                    allow = _sim_allow(w, plan, qg, kg, c, segments)
                    counts[qg * c:(qg + 1) * c,
                           kg * c:(kg + 1) * c] += allow
    return counts


def global_allow(mask: MaskSpec, T: int, segments=None) -> np.ndarray:
    """(T, T) ground-truth attend matrix of the global mask at absolute
    positions: what the distributed schedules must jointly reproduce."""
    pos = np.arange(T)
    qs = ks = None
    if mask.document:
        if segments is not None:
            qs = np.asarray(segments)[:, None]
            ks = np.asarray(segments)[None, :]
        elif mask.boundaries is not None:
            seg = np.array([mask.segment_index(i) for i in range(T)])
            qs, ks = seg[:, None], seg[None, :]
        else:
            raise ValueError("document mask needs segments or boundaries")
    allow = mask.allow(pos[:, None], pos[None, :], qs, ks)
    if allow is None:
        return np.ones((T, T), bool)
    return np.asarray(allow)


# ---------------------------------------------------------------------------
# Static comm / compute cost model (drives schedule="auto")
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlanCost:
    """Per-rank static cost of one plan (or the ulysses baseline):
    ``comm_bytes_*`` are hop-weighted link bytes, ``flops_*`` the kernels'
    matmul FLOPs after static mask pruning (items whose offsets depend on
    the rank count dense)."""
    schedule: str
    exec_steps: int
    total_steps: int
    kernel_calls: int
    flops_fwd: float
    flops_bwd: float
    comm_bytes_fwd: float
    comm_bytes_bwd: float

    def time_estimate(self, include_bwd: bool = True) -> dict:
        """Two-term (compute, collective) seconds at
        ``analysis.roofline``'s H100 constants; no HBM term (the same for
        every schedule)."""
        from repro_torch.analysis.roofline import schedule_cost_terms
        fl = self.flops_fwd + (self.flops_bwd if include_bwd else 0.0)
        by = self.comm_bytes_fwd + (self.comm_bytes_bwd if include_bwd
                                    else 0.0)
        return schedule_cost_terms(flops=fl, comm_bytes=by)


def _band_pairs(mask: MaskSpec, cq: int, ck: int) -> float:
    """Unmasked (q, kv) pairs of a static work mask over a (cq, ck) chunk
    pair (document refinement is dynamic and left out: an upper bound)."""
    if not (mask.causal or (mask.window and mask.window > 0)):
        return float(cq * ck)
    qpos = mask.q_offset - mask.kv_offset + np.arange(cq)
    hi = np.minimum(qpos, ck - 1) if mask.causal \
        else np.full(cq, ck - 1)
    lo = np.maximum(qpos - mask.window + 1, 0) if mask.window \
        else np.zeros(cq)
    return float(np.maximum(hi - lo + 1, 0).sum())


def plan_cost(plan: SchedulePlan, *, B: int = 1, Hq: int = 8,
              Hkv: Optional[int] = None, Dqk: int = 64,
              Dv: Optional[int] = None, bpe: int = 2,
              dynamic_seg: bool = False) -> PlanCost:
    """Static per-rank cost of a plan: kernel FLOPs a Work item (after
    static mask pruning) and hop-weighted ring bytes an executed shift,
    forward and backward."""
    Hkv = Hq if Hkv is None else Hkv
    Dv = Dqk if Dv is None else Dv
    c = plan.chunk_len
    f_fwd = f_bwd = 0.0
    for s in plan.steps:
        for w in s.work:
            pairs = float(c * c) if w.dyn_offsets \
                else _band_pairs(w.mask, c, c)
            f_fwd += 2.0 * B * Hq * pairs * (Dqk + Dv)
            f_bwd += 2.0 * B * Hq * pairs * (3 * Dqk + 2 * Dv)
    kv_bytes = B * plan.Tl * Hkv * (Dqk + Dv) * bpe if plan.uses_ring \
        else 0.0
    seg_bytes = B * plan.Tl * 4 if (plan.mask.document and dynamic_seg
                                    and (plan.uses_ring or plan.ship_q)) \
        else 0.0
    q_bytes = B * plan.Tl * Hq * Dqk * bpe if plan.ship_q else 0.0
    do_bytes = B * plan.Tl * Hq * Dv * bpe if plan.ship_q else 0.0
    stat_bytes = 2 * B * plan.Tl * Hq * 4 if plan.ship_q else 0.0
    dkv_bytes = B * plan.Tl * Hkv * (Dqk + Dv) * 4 if plan.uses_ring \
        else 0.0
    dqb_bytes = B * plan.Tl * Hq * Dqk * 4 if plan.ship_q else 0.0
    shifts = [s.shift for s in plan.steps[1:]]
    D = sum(shifts)
    c_fwd = (kv_bytes + seg_bytes + q_bytes) * D
    for s in plan.steps:
        for w in s.work:
            for r in w.routes:
                if r.ship:
                    c_fwd += (B * c * Hq * Dv * bpe
                              + B * c * Hq * 4) * abs(r.ship)
    # backward: data containers travel D hops; the traveling accumulators
    # move on every transition after the first executed step (D − s1 hops)
    # and go home with one D-hop shift
    acc_hops = (D - shifts[0] if shifts else 0) + (D if shifts else 0)
    c_bwd = (kv_bytes + seg_bytes + q_bytes + do_bytes + stat_bytes) * D \
        + (dkv_bytes + dqb_bytes) * acc_hops
    return PlanCost(schedule=plan.name, exec_steps=plan.exec_steps,
                    total_steps=plan.total_steps,
                    kernel_calls=plan.kernel_calls,
                    flops_fwd=f_fwd, flops_bwd=f_bwd,
                    comm_bytes_fwd=c_fwd, comm_bytes_bwd=c_bwd)


def ulysses_cost(mask: MaskSpec, P: int, *, Tl: int, B: int = 1,
                 Hq: int = 8, Hkv: Optional[int] = None, Dqk: int = 64,
                 Dv: Optional[int] = None, bpe: int = 2) -> PlanCost:
    """Analytic per-rank cost of the DeepSpeed-Ulysses baseline: q/k/v and
    o all-to-all, whole-sequence attention over Hq/P heads."""
    Hkv = Hq if Hkv is None else Hkv
    Dv = Dqk if Dv is None else Dv
    Tg = P * Tl
    pairs = _band_pairs(mask, Tg, Tg)
    f_fwd = 2.0 * B * (Hq / P) * pairs * (Dqk + Dv)
    f_bwd = 2.0 * B * (Hq / P) * pairs * (3 * Dqk + 2 * Dv)
    a2a = (P - 1) / P
    io_fwd = B * Tl * (Hq * Dqk + Hkv * (Dqk + Dv) + Hq * Dv) * bpe \
        + B * Tl * Hq * 4                     # q, k, v in; o, lse back
    c_fwd = io_fwd * a2a
    c_bwd = 2.0 * c_fwd                       # dq, dk, dv and do
    return PlanCost(schedule="ulysses", exec_steps=1, total_steps=1,
                    kernel_calls=1, flops_fwd=f_fwd, flops_bwd=f_bwd,
                    comm_bytes_fwd=c_fwd, comm_bytes_bwd=c_bwd)


def plan2d_cost(p2: Plan2D, *, B: int = 1, Dqk: int = 64,
                Dv: Optional[int] = None, bpe: int = 2,
                dynamic_seg: bool = False) -> PlanCost:
    """Static per-rank cost of a 2D plan: the inner plan's at the factored
    shapes (Hq/u heads over T/r tokens) plus the head axis's traffic
    (all-to-all factor (u − 1)/u, all-gather u − 1)."""
    from repro_torch.analysis.roofline import a2a_bytes, allgather_bytes
    Dv = Dqk if Dv is None else Dv
    u = p2.u
    Hql = p2.Hq // u
    Hkv_in = Hql if p2.kv_mode == "replicate" else p2.Hkv // u
    inner = plan_cost(p2.inner, B=B, Hq=Hql, Hkv=Hkv_in, Dqk=Dqk, Dv=Dv,
                      bpe=bpe, dynamic_seg=dynamic_seg)
    Tc = p2.inner.Tl // u                       # tokens a rank
    q_b = B * Tc * p2.Hq * Dqk * bpe
    o_b = B * Tc * p2.Hq * Dv * bpe
    lse_b = B * Tc * p2.Hq * 4
    kv_b = B * Tc * p2.Hkv * (Dqk + Dv) * bpe
    seg_b = B * Tc * 4 if dynamic_seg else 0.0
    if p2.kv_mode == "scatter":
        kv_in = a2a_bytes(kv_b, u)
        kv_grad_home = a2a_bytes(kv_b, u)
    else:
        kv_in = allgather_bytes(kv_b, u)
        # the ring all-reduce of the whole-row float32 KV gradients
        kv_grad_home = 2.0 * a2a_bytes(
            B * (Tc * u) * p2.Hkv * (Dqk + Dv) * 4, u)
    c_fwd = inner.comm_bytes_fwd + a2a_bytes(q_b + o_b + lse_b, u) \
        + kv_in + allgather_bytes(seg_b, u)
    c_bwd = inner.comm_bytes_bwd \
        + a2a_bytes(2 * q_b + 2 * o_b + lse_b, u) \
        + kv_in + kv_grad_home + allgather_bytes(seg_b, u)
    return PlanCost(schedule=p2.name, exec_steps=inner.exec_steps,
                    total_steps=inner.total_steps,
                    kernel_calls=inner.kernel_calls,
                    flops_fwd=inner.flops_fwd, flops_bwd=inner.flops_bwd,
                    comm_bytes_fwd=c_fwd, comm_bytes_bwd=c_bwd)


def factorizations(P: int):
    """Every (r, u) with r·u == P: the 2D search space of
    ``choose_schedule(..., factorize=True)``."""
    return [(r, P // r) for r in range(1, P + 1) if P % r == 0]


def choose_inner_schedule(mask: MaskSpec, r: int, u: int, *, Tl_dev: int,
                          B: int = 1, Hq: int = 8,
                          Hkv: Optional[int] = None, Dqk: int = 64,
                          Dv: Optional[int] = None, bpe: int = 2,
                          dynamic_seg: bool = False,
                          include_bwd: bool = True) -> str:
    """``schedule="auto"`` for a fixed (r, u) grid (the mesh is built, so
    only the inner seq-axis schedule is free): the cheapest capable
    ring-family plan by the 2D cost.  zigzag is left out: its layout
    permutation is the caller's contract."""
    Hkv = Hq if Hkv is None else Hkv
    if r == 1:
        return "ring"
    scored = []
    for i, name in enumerate(("balanced", "ring")):
        if not plan2d_capable(name, mask, r=r, u=u, Hq=Hq, Hkv=Hkv):
            continue
        p2 = build_plan2d(name, mask, r, u, Tl_dev, Hq=Hq, Hkv=Hkv)
        t = plan2d_cost(p2, B=B, Dqk=Dqk, Dv=Dv, bpe=bpe,
                        dynamic_seg=dynamic_seg) \
            .time_estimate(include_bwd)["step_s_lower_bound"]
        scored.append((t, i, name))
    if not scored:
        raise ValueError(
            f"schedule='auto': no capable inner schedule for mask "
            f"{mask.kind!r} on a 2D (r={r}, u={u}) mesh with heads "
            f"({Hq}, {Hkv}) — prefix_lm and non-causal sliding windows "
            f"need r == 1 (head-only scatter) or a single-shard axis")
    return min(scored)[2]


def choose_schedule(mask: MaskSpec, P: int, *, Tl: int, B: int = 1,
                    Hq: int = 8, Hkv: Optional[int] = None, Dqk: int = 64,
                    Dv: Optional[int] = None, bpe: int = 2,
                    dynamic_seg: bool = False, include_bwd: bool = True,
                    factorize: bool = False):
    """``schedule="auto"``: the cheapest capable schedule for (mask, P,
    shapes).  Candidates: balanced and ring where the plan serves the mask
    (zigzag is left out: its layout permutation is the caller's), and
    ulysses where the head counts divide P.

    The ranking reads the active tuning table (:mod:`repro_torch.tune`)
    first: a measured row at the nearest (mask kind, P, seq) bucket decides
    outright; else the table's calibrated coefficients rank the
    candidates; with no table the roofline (``PlanCost.time_estimate``)
    decides.  Ties break toward balanced, then ring, then ulysses.

    ``include_bwd`` is the cost horizon and a capability rule: with it,
    ulysses under a mask its ring backward cannot serve is left out, so
    the name never raises at execution.  ``factorize=True`` searches the
    2D (seq = r, head = u) grids too and returns ``(name, r, u)``, ranked
    by the analytic cost alone (a table's rows are 1D walls)."""
    Hkv = Hq if Hkv is None else Hkv
    if factorize:
        return _choose_factorized(mask, P, Tl=Tl, B=B, Hq=Hq, Hkv=Hkv,
                                  Dqk=Dqk, Dv=Dv, bpe=bpe,
                                  dynamic_seg=dynamic_seg,
                                  include_bwd=include_bwd)
    if P <= 1:
        return "ring"
    names = [n for n in ("balanced", "ring") if plan_capable(n, mask)]
    if ulysses_capable(mask, P, Hq, Hkv, include_bwd=include_bwd):
        names.append("ulysses")
    if not names:
        raise ValueError(
            f"schedule='auto': no capable schedule for mask {mask.kind!r} "
            f"with P={P}, heads=({Hq}, {Hkv}) — prefix_lm and non-causal "
            f"sliding windows need absolute positions (ulysses, which "
            f"needs head counts divisible by P) or a single-shard axis")
    if len(names) == 1:
        return names[0]

    from repro_torch.tune.table import active_table
    tab = active_table()
    if tab is not None:
        hit = tab.best_schedule(mask_kind=mask.kind, P=P, seq=P * Tl,
                                candidates=names)
        if hit is not None:
            return hit
    coeffs = tab.coeffs() if tab is not None else None

    scored = []
    order = {"balanced": 0, "ring": 1, "ulysses": 2}
    for name in names:
        if coeffs is not None:
            from repro_torch.tune.calibrate import (predict_s,
                                                    schedule_features)
            feats = schedule_features(
                name, mask_kind=mask.kind, P=P, seq=P * Tl, B=B, Hq=Hq,
                Hkv=Hkv, Dqk=Dqk, bpe=bpe, window=mask.window or None,
                dynamic_seg=dynamic_seg, include_bwd=include_bwd)
            if feats is None:
                continue
            t = predict_s(feats, coeffs)
        elif name == "ulysses":
            t = ulysses_cost(mask, P, Tl=Tl, B=B, Hq=Hq, Hkv=Hkv, Dqk=Dqk,
                             Dv=Dv, bpe=bpe).time_estimate(
                                 include_bwd)["step_s_lower_bound"]
        else:
            t = plan_cost(build_plan(name, mask, P, Tl), B=B, Hq=Hq,
                          Hkv=Hkv, Dqk=Dqk, Dv=Dv, bpe=bpe,
                          dynamic_seg=dynamic_seg).time_estimate(
                              include_bwd)["step_s_lower_bound"]
        scored.append((t, order[name], name))
    return min(scored)[2]


def _choose_factorized(mask: MaskSpec, P: int, *, Tl: int, B: int,
                       Hq: int, Hkv: int, Dqk: int, Dv: Optional[int],
                       bpe: int, dynamic_seg: bool, include_bwd: bool):
    """The 2D branch of :func:`choose_schedule`: every capable (schedule,
    r, u) with r·u == P ranked by the analytic cost; (r = P, u = 1) are
    the 1D plans, (r = 1, u = P) pure head parallelism through the plan
    path (any mask: the kernel after the scatter sees the whole sequence).
    Ties break toward smaller u, then balanced before ring."""
    if P <= 1:
        return ("ring", 1, 1)
    order = {"balanced": 0, "ring": 1}
    scored = []
    for r, u in factorizations(P):
        for name in ("balanced", "ring"):
            if u == 1:
                if not plan_capable(name, mask):
                    continue
                cost = plan_cost(build_plan(name, mask, P, Tl), B=B,
                                 Hq=Hq, Hkv=Hkv, Dqk=Dqk, Dv=Dv, bpe=bpe,
                                 dynamic_seg=dynamic_seg)
            else:
                if name == "balanced" and r == 1:
                    continue          # the same plan as ring
                if not plan2d_capable(name, mask, r=r, u=u, Hq=Hq,
                                      Hkv=Hkv):
                    continue
                p2 = build_plan2d(name, mask, r, u, Tl, Hq=Hq, Hkv=Hkv)
                cost = plan2d_cost(p2, B=B, Dqk=Dqk, Dv=Dv, bpe=bpe,
                                   dynamic_seg=dynamic_seg)
            t = cost.time_estimate(include_bwd)["step_s_lower_bound"]
            scored.append((t, u, order[name], (name, r, u)))
    if not scored:
        raise ValueError(
            f"schedule='auto': no capable (schedule, r, u) factorization "
            f"of P={P} for mask {mask.kind!r} with heads ({Hq}, {Hkv}) — "
            f"head-parallel factorizations need Hq % u == 0 and a uniform "
            f"GQA group structure")
    return min(scored)[3]

"""Continuous-batching scheduler: admission queue, per-request lifecycle
state machine, and block-pool-pressure preemption over a
:class:`repro.serve.cache.PagedKVCache`.

**Request lifecycle** — every request reaches exactly one terminal state::

    QUEUED ──admit──> PREFILL ──chunks done──> DECODE ──stop/length──> FINISHED
      │  ▲              │   │                    │   │
      │  └── preempt ───┴───│──── preempt ───────┘   ├──> EXPIRED  (deadline)
      │                     │                        └──> FAILED   (quarantine,
      ├──> REJECTED (shed at submit)                            retries exhausted)
      └──> EXPIRED  (deadline while queued)          PREFILL can also EXPIRE

Terminal states are *structured statuses*, not exceptions: ``submit`` on a
full queue / exhausted headroom / never-fitting request returns a
``REJECTED`` request (``finish_reason`` says why) without touching the
block pool, and deadline expiry releases a running request's blocks while
keeping its partial ``emitted`` stream.

Per engine step the scheduler produces a :class:`StepPlan`:

  0. **deadline expiry** — requests (queued or running) whose TTL elapsed
     on the scheduler *clock* (one tick per step, plus slow-step fault
     penalties) terminate ``EXPIRED``; running victims release their
     blocks but keep their partial stream.
  1. **window reclamation** — when the model has a sliding window, every
     running request drops its refs on blocks wholly below the window of
     its next write position (freed storage instead of masked storage).
  2. **decode growth** — every running request about to write a token at a
     block boundary gets one more block; when the pool is exhausted the
     *youngest* running request (highest admission sequence) is preempted:
     its block refs are dropped (shared prefix blocks survive under their
     other owners) and it requeues at the *front* of the admission queue
     (recompute-style preemption — on re-admission its full context
     ``prompt ++ emitted[:-1]`` is re-prefilled, usually mostly from the
     prefix cache, and its pending last token re-enters decode, so no
     output token is ever lost or re-sampled).
  3. **admission** — FIFO: while a batch slot is free and the pool can hold
     the head request's prefill blocks, it is admitted; cached prefix
     blocks are *shared* instead of allocated (``Request.cached`` starts
     at the hit length).  Head-of-line blocking keeps admission
     deterministic and starvation-free.  When the **forward-progress
     watchdog** has tripped (a window of repeated preempt/readmit with no
     emitted tokens — preemption livelock), admission degrades to *serial*
     (at most one running request) until a full window passes with
     progress and no preemptions.
  4. **chunk planning** — each mid-prefill request contributes one prefill
     chunk of at most ``prefill_chunk_tokens`` tokens, *aligned to
     absolute context positions* (chunk boundaries are multiples of the
     chunk size), so a request's chunk layout — and hence its numerics —
     never depends on what else is in the batch or on how much of its
     prefix was cached.  Copy-on-write forks for every block the step will
     write run here, under the same preempt-on-exhaustion loop as decode
     growth.

Everything is host-side and deterministic in the submit/step sequence —
the property the batch-invariance suite (tests/test_serving_engine.py)
checks against solo runs, and the chaos suite (tests/test_chaos.py)
checks under seeded fault schedules.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serve.cache import PagedKVCache, PoolExhausted

# ----------------------------------------------------------- request states
QUEUED = "queued"          # in the admission queue
PREFILL = "prefill"        # admitted, context KV still being written
DECODE = "decode"          # fully prefilled, emitting tokens
FINISHED = "finished"      # terminal: stop token / length budget
REJECTED = "rejected"      # terminal: shed at submit (never touched pool)
EXPIRED = "expired"        # terminal: deadline elapsed (partial stream kept)
FAILED = "failed"          # terminal: quarantined / retries exhausted

RUNNING_STATES = (PREFILL, DECODE)
TERMINAL_STATES = (FINISHED, REJECTED, EXPIRED, FAILED)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling/stop configuration."""
    max_new_tokens: int = 16
    temperature: float = 0.0
    seed: int = 0                      # per-request PRNG stream
    stop_tokens: Tuple[int, ...] = ()


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (T,) int32
    params: SamplingParams
    state: str = QUEUED
    slot: int = -1
    seq: int = -1                      # admission sequence (preempt victim
    #                                    order; re-assigned on re-admission)
    emitted: List[int] = dataclasses.field(default_factory=list)
    cached: int = 0                    # tokens with KV in the pool
    finish_reason: Optional[str] = None
    deadline: Optional[int] = None     # absolute scheduler-clock tick
    retries: int = 0                   # transient-step-fault retries so far
    n_preemptions: int = 0
    n_hit: int = 0                     # prefix-cache tokens at last admission
    submit_step: int = -1
    finish_step: int = -1

    @property
    def done(self) -> bool:
        return self.state in TERMINAL_STATES

    @property
    def pending(self) -> int:
        """The context token whose KV is not yet cached — the next decode
        step's input.  For a fresh request this is the *last prompt
        token*: prefill stops one short, so prefill logits are never
        consumed and prefill lengths can be freely bucket-padded (the
        first sampled token comes out of the first decode step)."""
        return int(self.emitted[-1] if self.emitted else self.prompt[-1])

    @property
    def context(self) -> np.ndarray:
        """prompt ++ emitted (the full token sequence so far)."""
        return np.concatenate([self.prompt,
                               np.asarray(self.emitted, np.int32)])

    @property
    def n_prefill(self) -> int:
        """Prefill length: everything but the pending token."""
        return len(self.prompt) + len(self.emitted) - 1

    @property
    def prefill_tokens(self) -> np.ndarray:
        """What (re-)admission must prefill: everything but the pending
        token (whose KV the next decode step writes). May be empty
        (single-token prompt)."""
        return self.context[:-1]


@dataclasses.dataclass
class StepPlan:
    admitted: List[Request]
    decode: List[Request]              # requests decode-ready this step
    preempted: List[Request]
    chunks: List[Tuple[Request, int, int]] = dataclasses.field(
        default_factory=list)          # (request, start, n_tokens)
    expired: List[Request] = dataclasses.field(default_factory=list)


class Scheduler:
    def __init__(self, cache: PagedKVCache, max_batch: Optional[int] = None,
                 *, prefill_chunk_tokens: int = 0,
                 max_queue: Optional[int] = None,
                 admit_watermark: float = 0.0,
                 watchdog_window: int = 8,
                 watchdog_threshold: int = 3,
                 lookahead: int = 0):
        self.cache = cache
        self.max_batch = max_batch or cache.max_reqs
        if self.max_batch > cache.max_reqs:
            raise ValueError("max_batch exceeds the cache's table rows")
        if prefill_chunk_tokens < 0:
            raise ValueError("prefill_chunk_tokens must be >= 0 "
                             "(0 = whole-prompt prefill)")
        if not 0.0 <= admit_watermark <= 1.0:
            raise ValueError("admit_watermark is a free-block fraction "
                             "in [0, 1]")
        if lookahead < 0:
            raise ValueError("lookahead must be >= 0")
        self.prefill_chunk_tokens = int(prefill_chunk_tokens)
        # speculative-decoding write span: each decode step may write up
        # to ``lookahead`` draft rows beyond the pending token, so block
        # growth / COW forks / admission reservations all cover them
        self.lookahead = int(lookahead)
        self.window = int((cache.cfg.attn.window or 0)
                          if cache.cfg.attn else 0)
        # admission control: bounded queue + block-headroom watermark —
        # both shed with a structured REJECTED status instead of blocking
        self.max_queue = max_queue
        self.admit_watermark = float(admit_watermark)
        self.waiting: Deque[Request] = deque()
        self.running: Dict[int, Request] = {}      # slot -> request
        self._next_rid = 0
        self._adm_seq = 0
        self.n_preemptions = 0
        self.step_count = 0
        # virtual clock: one tick per plan(); slow-step faults add extra
        # ticks, so deadlines are deterministic AND fault-sensitive
        self.clock = 0
        # forward-progress watchdog over a sliding window of recent steps
        self.watchdog_window = int(watchdog_window)
        self.watchdog_threshold = int(watchdog_threshold)
        self.serial_admission = False
        self._history: Deque[Tuple[int, int]] = deque(
            maxlen=self.watchdog_window)           # (preempts, tokens)
        self._step_preempts = 0
        self.counters = dict(shed=0, expired=0, failed=0, watchdog_trips=0,
                             storm_preempts=0)

    # ------------------------------------------------------------- intake
    def _headroom(self) -> float:
        """Fraction of usable blocks that admission could still claim —
        free blocks plus cache-pinned blocks (LRU eviction reclaims those
        under pressure)."""
        a = self.cache.allocator
        return (a.n_free + self.cache.n_cache_blocks) / a.n_usable

    def _reject(self, req: Request, reason: str) -> Request:
        req.state = REJECTED
        req.finish_reason = reason
        req.finish_step = self.step_count
        self.counters["shed"] += 1
        return req

    def submit(self, prompt, params: SamplingParams,
               deadline_steps: Optional[int] = None) -> Request:
        """Enqueue a request — or shed it: the returned request is
        ``REJECTED`` (with a reason, having never touched the block pool)
        when it can never fit, the queue is at ``max_queue`` depth, or
        free-block headroom is below ``admit_watermark``."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        req = Request(rid=self._next_rid, prompt=prompt, params=params,
                      submit_step=self.step_count)
        self._next_rid += 1
        if deadline_steps is not None:
            if deadline_steps <= 0:
                raise ValueError("deadline_steps must be positive")
            req.deadline = self.clock + int(deadline_steps)
        total = prompt.size + params.max_new_tokens
        if not self.cache.fits(total):
            return self._reject(req, "never_fits")
        if self.max_queue is not None and len(self.waiting) >= self.max_queue:
            return self._reject(req, "queue_full")
        if self.admit_watermark and self._headroom() < self.admit_watermark:
            return self._reject(req, "no_headroom")
        self.waiting.append(req)
        return req

    # ------------------------------------------------------------ helpers
    def _free_slot(self) -> Optional[int]:
        for s in range(self.max_batch):
            if s not in self.running:
                return s
        return None

    def _preempt_youngest(self) -> Optional[Request]:
        if not self.running:
            return None
        victim = max(self.running.values(), key=lambda r: r.seq)
        self._preempt(victim)
        return victim

    def _preempt(self, victim: Request) -> None:
        self.cache.release(victim.slot, victim.rid)
        del self.running[victim.slot]
        victim.state = QUEUED
        victim.slot = -1
        victim.cached = 0
        victim.n_preemptions += 1
        self.n_preemptions += 1
        self._step_preempts += 1
        self.waiting.appendleft(victim)

    def force_preempt(self, n: int) -> List[Request]:
        """Fault hook (preempt storm): preempt the ``n`` youngest running
        requests regardless of pool pressure."""
        victims = []
        for _ in range(n):
            v = self._preempt_youngest()
            if v is None:
                break
            victims.append(v)
        self.counters["storm_preempts"] += len(victims)
        return victims

    def _with_preempt(self, req: Request, op, preempted) -> bool:
        """Run a pool-consuming cache op, preempting the youngest request
        on exhaustion until it succeeds; returns False when ``req`` itself
        was the last victim (it left the running set)."""
        while True:
            try:
                op()
                return True
            except PoolExhausted:
                victim = self._preempt_youngest()
                if victim is not None:
                    preempted.append(victim)
                if victim is None or victim is req:
                    return False

    def _terminate(self, req: Request, state: str, reason: str) -> None:
        """Move a request to a terminal state, releasing its blocks if it
        was running and dequeueing it if it was waiting."""
        if req.slot >= 0:
            self.cache.release(req.slot, req.rid)
            del self.running[req.slot]
            req.slot = -1
        elif req in self.waiting:
            self.waiting.remove(req)
        req.state = state
        req.finish_reason = reason
        req.finish_step = self.step_count

    def finish(self, req: Request, reason: str) -> None:
        self._terminate(req, FINISHED, reason)

    def expire(self, req: Request) -> None:
        """Deadline elapsed: blocks released, partial ``emitted`` kept."""
        self._terminate(req, EXPIRED, "deadline")
        self.counters["expired"] += 1

    def fail(self, req: Request, reason: str) -> None:
        """Terminal failure (NaN quarantine, retries exhausted): blocks
        released — refcounts on shared blocks stay intact — and the
        request never re-enters the queue."""
        self._terminate(req, FAILED, reason)
        self.counters["failed"] += 1

    # ----------------------------------------------------------- watchdog
    def advance_clock(self, ticks: int) -> None:
        """Fault hook (slow step): the step took ``ticks`` extra virtual
        time — deadlines feel it."""
        self.clock += int(ticks)

    def record_progress(self, n_tokens: int) -> None:
        """Engine calls this at the end of every step with the number of
        tokens it emitted; drives the forward-progress watchdog."""
        self._history.append((self._step_preempts, n_tokens))
        self._step_preempts = 0
        if len(self._history) < self.watchdog_window:
            return
        preempts = sum(p for p, _ in self._history)
        tokens = sum(t for _, t in self._history)
        if not self.serial_admission:
            # livelock signature: the batch keeps churning through
            # preempt/readmit without emitting anything
            if preempts >= self.watchdog_threshold and tokens == 0:
                self.serial_admission = True
                self.counters["watchdog_trips"] += 1
                self._history.clear()
        else:
            # pressure cleared: a full window with progress, no preemption
            if preempts == 0 and tokens > 0:
                self.serial_admission = False
                self._history.clear()

    # --------------------------------------------------------- speculation
    def spec_budget(self, req: Request) -> int:
        """Draft tokens ``req`` may verify this step: capped by the
        configured ``lookahead``, the remaining token budget (a draft
        beyond the last committable token is wasted verify work), and the
        per-request block capacity (every draft row's KV write at
        ``cached + 1 + i`` must be tableable)."""
        if not self.lookahead:
            return 0
        rem = req.params.max_new_tokens - len(req.emitted)
        cap = self.cache.max_blocks_per_req * self.cache.block_size
        return max(0, min(self.lookahead, rem - 1, cap - 1 - req.cached))

    # --------------------------------------------------------------- plan
    def plan(self) -> StepPlan:
        """One scheduling round: expire, reclaim, grow/preempt, admit,
        plan chunks + copy-on-write forks.  The caller (engine) runs the
        ``chunks`` (prefill), then one decode step over ``decode``."""
        self.step_count += 1
        self.clock += 1
        preempted: List[Request] = []

        # 0. deadline expiry — queued and running requests past their TTL
        # terminate EXPIRED (running victims keep their partial stream)
        expired: List[Request] = []
        for req in [r for r in self.waiting
                    if r.deadline is not None and self.clock >= r.deadline]:
            self.expire(req)
            expired.append(req)
        for slot in sorted(self.running):
            req = self.running[slot]
            if req.deadline is not None and self.clock >= req.deadline:
                self.expire(req)
                expired.append(req)

        # 1. sliding-window reclamation — blocks wholly below the window
        # of the next write position are freed, not merely masked
        if self.window:
            for slot in sorted(self.running):
                req = self.running[slot]
                self.cache.reclaim_window(slot, req.rid, req.cached,
                                          self.window)

        # 2. decode growth — ascending slot order is the deterministic tie
        # break; a victim drops out of this step's plan entirely.
        for slot in sorted(self.running):
            req = self.running.get(slot)
            if req is None:
                continue                         # preempted below this step
            if req.cached < req.n_prefill:
                continue
            # the step's write span is the pending token plus any
            # speculative draft rows — growth must cover all of it
            top = req.cached + self.spec_budget(req)
            while self.running.get(slot) is req \
                    and self.cache.needs_block(slot, top):
                if not self._with_preempt(
                        req, lambda: self.cache.extend(slot, req.rid),
                        preempted):
                    break

        # 3. admission (FIFO, head-of-line blocking); prefix-cache hits
        # start the request part-prefilled.  Watchdog-degraded mode admits
        # serially: at most one running request until pressure clears.
        admitted: List[Request] = []
        while self.waiting:
            if self.serial_admission and self.running:
                break
            head = self.waiting[0]
            slot = self._free_slot()
            if slot is None:
                break
            toks = head.prefill_tokens
            # +1: the first decode write lands at position n_prefill, so
            # the slot must own the block covering it up front; +lk: the
            # speculative write span too.  lk's remaining-budget cap keeps
            # the total < prompt + max_new_tokens, so submit's fits()
            # check still guarantees a solo request can always admit
            lk = min(self.lookahead,
                     max(head.params.max_new_tokens
                         - len(head.emitted) - 1, 0))
            try:
                n_hit = self.cache.assign(slot, head.rid,
                                          len(toks) + 1 + lk, tokens=toks)
            except PoolExhausted:
                break
            self.waiting.popleft()
            head.slot = slot
            head.seq = self._adm_seq
            self._adm_seq += 1
            head.cached = n_hit                  # hit KV is already pooled
            head.n_hit = n_hit
            head.state = PREFILL if n_hit < head.n_prefill else DECODE
            self.running[slot] = head
            admitted.append(head)

        # 4. chunk planning + copy-on-write forks for this step's writes
        chunks: List[Tuple[Request, int, int]] = []
        decode: List[Request] = []
        for slot in sorted(self.running):
            req = self.running.get(slot)
            if req is None:
                continue
            n_pref = req.n_prefill
            if req.cached < n_pref:              # mid-prefill: one chunk
                req.state = PREFILL
                end = self._chunk_end(req)
                # a chunk that finishes prefill enters decode in the same
                # step, so its write span includes the decode write (and
                # the speculative rows — admission reserved their blocks)
                w1 = end + 1 + self.spec_budget(req) if end == n_pref \
                    else end
                if not self._with_preempt(
                        req, lambda: self.cache.ensure_writable(
                            slot, req.rid, req.cached, w1), preempted):
                    continue
                chunks.append((req, req.cached, end - req.cached))
                if end == n_pref:                # finishes prefill: decode
                    decode.append(req)           # in the same step
            else:                                # decode-phase
                req.state = DECODE
                w1 = req.cached + 1 + self.spec_budget(req)
                if self._with_preempt(
                        req, lambda: self.cache.ensure_writable(
                            slot, req.rid, req.cached, w1), preempted):
                    decode.append(req)

        return StepPlan(admitted=admitted, decode=decode,
                        preempted=[p for p in preempted if p is not None],
                        chunks=chunks, expired=expired)

    def _chunk_end(self, req: Request) -> int:
        """End position of the request's next prefill chunk: aligned to
        absolute multiples of the chunk size (so chunk boundaries — and
        the numerics they shape — are independent of cache hits and batch
        composition), capped at the prefill length."""
        C = self.prefill_chunk_tokens
        if not C:
            return req.n_prefill
        return min(req.n_prefill, (req.cached // C + 1) * C)

    @property
    def idle(self) -> bool:
        return not self.waiting and not self.running

"""Serving engines (port of the reference ``serve/engine.py``: the paged
``Engine`` with speculative decoding and fault injection, and
``FixedSlotEngine``).

:class:`Engine` is the paged continuous-batching engine:

  * ``submit(prompt, max_new_tokens=…, temperature=…, seed=…,
    stop_tokens=…, deadline_steps=…) -> rid`` — enqueue a request; the
    scheduler may shed it (terminal ``REJECTED`` with a reason);
  * ``step() -> {rid: [new tokens]}`` — one engine step: apply the step's
    scheduled faults, admit waiting requests (sharing prefix-cache
    blocks), run each mid-prefill request's next chunk
    (``model.prefill_chunk`` writes straight into pool blocks; kernel A
    attends), then ONE decode step over the decode-ready slots
    (per-request positions, kernel B attends through the block table) and
    sampling — or, with ``spec=``, one speculative step: the draft
    proposes, ``model.verify`` scores the pending token and the proposals
    at Tq = depth + 1 (kernel B), and the accept/reject walk commits
    (``serve/speculative.py``);
  * ``stream(rid)`` / ``run()`` / ``generate()`` — drive ``step``;
  * ``warm_prefill(max_ctx)`` — run every prefill chunk shape a context of
    up to ``max_ctx`` tokens reaches once, against the null block;
  * ``stats()`` — counters, and the seconds spent in prefill chunks and in
    decode (or verify) steps (on a CUDA device, CUDA events around each
    phase, read only once they have completed, so timing adds no sync to
    the loop).

The pending-token design is the reference's: prefill covers
``context[:-1]`` and the last context token enters through decode, so
prefill never computes logits and chunks can be bucket-padded (padded rows
write to the null block).  Preemption is recompute-style.

Robustness (``serve/faults.py``): ``faults=FaultInjector(...)`` threads a
seeded fault schedule through the step loop (pool squeezes, NaN logits,
dropped and slow steps, corrupted blocks, preemption storms), replayable
exactly.  A row with non-finite logits is quarantined (terminal
``FAILED``, its exclusive blocks scrubbed) while the rest of the batch
streams on; a dropped step advances no request and the engine retries with
capped exponential backoff, failing a request after ``max_retries``
drops; ``audit=True`` re-checks the allocator, the prefix trie and the
tables after every step.

Across ranks (``Engine(use_mesh_sharding=True)``, the default, on a model
built with a ``mesh``): every rank runs the same engine in lockstep — its
own scheduler, allocator, sampler and fault injector, making the same
decisions from the same logits — over a pool sharded on the sequence axis
(head-parallel or block-sharded, ``serve/cache.py``; an MLA model's latent
pool by blocks); the model runs batch-replicated, each rank writing and
reading its part of the pool, and an MoE model's chunks split their rows
over the ranks for the expert dispatch, so a fixed
``prefill_chunk_tokens`` must divide by the rank count (whole-prompt
chunks pad to a multiple of it).  On a 2D (seq, head) mesh the pool
shards over the seq axis alone, as the reference's: the u head ranks of a
seq shard hold the same part, bitwise, and a chunk's MoE rows split over
the seq axis (the expert group), each head rank dispatching its seq
rank's rows.

Sampling: greedy at temperature 0; otherwise the reference's draw,
``categorical(fold_in(PRNGKey(seed), position), logits / T)``, reproduced
on the host by :mod:`repro_torch.serve.prng` (threefry2x32 keys and bits,
Gumbel-max) — so a request's stream depends only on its own (prompt,
params), never on the batch around it, is the same on every device, and is
the reference's stream token for token.  Faults and drafts perturb
scheduling, never a surviving request's tokens.

:class:`FixedSlotEngine` is one prefill plus a dense cache stepped one token
at a time — the reference's dense-cache oracle of the paged engine, and its
long-context path: on a mesh the prompt is prefilled across the sequence
ranks and the cache stays sharded along the sequence, every rank running
the same decode loop (flash-decoding across the shards).  It also serves
the VLM (image rows before the prompt) and the encoder–decoder (a clip's
frames beside it), which the paged engine refuses, as the reference's
does.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serve import prng
from repro_torch.serve.cache import PagedKVCache
from repro_torch.serve.faults import FAULT_OWNER, FaultInjector
from repro_torch.serve.scheduler import (DECODE, PREFILL, Request,
                                         SamplingParams, Scheduler)
from repro_torch.serve.speculative import (AdaptiveDepth, DraftSource,
                                           SpecConfig, make_draft)


def _draw(row, temp: float, seed: int, position: int) -> int:
    """The reference's categorical draw of ``row / temp`` (float32 numpy
    logits) under ``fold_in(PRNGKey(seed), position)``."""
    key = prng.fold_in(prng.prng_key(seed), position)
    t = np.maximum(np.float32(temp), np.float32(1e-6))
    return int(prng.categorical(key, row / t))


def _sample(logits, temps, seeds, positions) -> np.ndarray:
    """Per-row sampling of ``logits`` (B, V) float32: greedy where
    ``temps[b] == 0``, else :func:`_draw` at ``positions[b]``."""
    out = logits.argmax(dim=-1).to(torch.int32).cpu().numpy()
    hot = [b for b in range(len(temps)) if temps[b] > 0]
    if hot:
        rows = logits[hot].float().cpu().numpy()
        for i, b in enumerate(hot):
            out[b] = _draw(rows[i], temps[b], seeds[b], positions[b])
    return out


class Engine:
    """Paged continuous-batching serving engine (see module docstring)."""

    _NKV_BUCKET = 4          # table-width bucket of a prefill chunk

    def __init__(self, model, params, *, max_batch: int = 8,
                 block_size: Optional[int] = None, n_blocks: int = 128,
                 max_blocks_per_req: Optional[int] = None,
                 use_mesh_sharding: bool = True,
                 prefill_chunk_tokens: int = 32,
                 prefix_cache: bool = True,
                 max_queue: Optional[int] = None,
                 admit_watermark: float = 0.0,
                 max_retries: int = 8,
                 backoff_cap: int = 8,
                 watchdog_window: int = 8,
                 watchdog_threshold: int = 3,
                 audit: bool = False,
                 faults: Optional[FaultInjector] = None,
                 spec: Optional[SpecConfig] = None,
                 draft: Optional[DraftSource] = None):
        cfg = model.cfg
        if cfg.arch_type not in ("dense", "moe"):
            raise ValueError(
                f"the paged engine serves dense/moe decoders "
                f"(got {cfg.arch_type!r}); use FixedSlotEngine")
        # a chunk's MoE rows split over the expert group: the sequence
        # axis (a 2D mesh's seq axis alone, r of its r·u ranks)
        split = (model.expert_group.size if model.expert_group is not None
                 else max(model.seq_size, 1))
        if (cfg.moe is not None and prefill_chunk_tokens
                and prefill_chunk_tokens % split):
            raise ValueError(
                f"prefill_chunk_tokens={prefill_chunk_tokens} does not "
                f"split over the {split} sequence ranks of an MoE model's "
                f"expert group")
        if model.batch_group is not None:
            # serving shapes are ragged (B = 1 chunks, a fixed slot batch
            # for decode): run the model batch-replicated, as the
            # reference rebuilds it with batch_axes=()
            model = type(model)(cfg, model.device, par=dataclasses.replace(
                model.par, batch_axes=()), impl=model.impl, mesh=model.mesh,
                latent_ring=model.latent_ring)
        self.model = model
        self.params = params
        self.cfg = cfg
        self.device = model.device
        self.cache = PagedKVCache.create(
            cfg, block_size=block_size, n_blocks=n_blocks,
            max_reqs=max_batch, max_blocks_per_req=max_blocks_per_req,
            prefix_cache=prefix_cache, device=self.device,
            dtype=model.dtype,
            mesh=model.mesh if use_mesh_sharding else None,
            seq_axis=model.par.seq_axis)
        # speculative decoding: the scheduler reserves the draft rows'
        # write span (lookahead); the decode step becomes a verify step
        self.spec = spec
        self.draft = (draft if draft is not None
                      else make_draft(spec) if spec is not None else None)
        self._adepth = (AdaptiveDepth(spec)
                        if spec is not None and spec.adaptive else None)
        # {draft budget: spec-step rows}: how deep requests really draft
        self.spec_depth_hist: Dict[int, int] = {}
        self.sched = Scheduler(self.cache, max_batch,
                               prefill_chunk_tokens=prefill_chunk_tokens,
                               max_queue=max_queue,
                               admit_watermark=admit_watermark,
                               watchdog_window=watchdog_window,
                               watchdog_threshold=watchdog_threshold,
                               lookahead=spec.depth if spec else 0)
        self.max_batch = max_batch
        self.prefill_chunk_tokens = int(prefill_chunk_tokens)
        # whole-prompt chunks pad to a multiple of the block size and the
        # sequence-shard count, r·u on a 2D mesh (the reference's compile
        # bucket)
        self._prefill_bucket = math.lcm(self.cache.block_size,
                                        max(model.seq_size, 1))
        self.requests: Dict[int, Request] = {}
        # robustness state
        self.audit_mode = bool(audit)
        self.max_retries = int(max_retries)
        self.backoff_cap = int(backoff_cap)
        self.injector = faults
        self.step_idx = 0                 # the fault schedule's timeline
        self._squeezes: List[Tuple[int, List[int]]] = []  # (release, ids)
        self._backoff_until = 0
        self._consec_drops = 0
        self.counters = dict(quarantined=0, retried=0, backoff_steps=0,
                             audit_passes=0, spec_proposed=0,
                             spec_accepted=0, spec_rejected=0,
                             spec_rollbacks=0, prefill_chunks=0,
                             prefill_tokens=0, decode_steps=0,
                             decode_tokens=0)
        self.seconds = dict(prefill=0.0, decode=0.0)
        self._spans: List[tuple] = []      # (phase, start, end) events

    def install_faults(self, injector: Optional[FaultInjector]) -> None:
        """(Re-)attach a fault schedule, its timeline starting at the next
        step (warm up fault-free, then storm)."""
        self.release_faults()
        self.injector = injector
        self.step_idx = 0

    # ------------------------------------------------------------- timing
    def _clock(self):
        """Now, on the device's timeline: a recorded CUDA event, or the
        host clock on a CPU device."""
        if self.device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _span(self, phase: str, start) -> None:
        end = self._clock()
        if isinstance(start, float):
            self.seconds[phase] += end - start
        else:
            self._spans.append((phase, start, end))

    def _fold_spans(self, wait: bool = False) -> None:
        """Add the spans whose end event has completed (all of them when
        ``wait``) into ``self.seconds``."""
        keep = []
        for phase, start, end in self._spans:
            if wait or end.query():
                end.synchronize()
                self.seconds[phase] += start.elapsed_time(end) / 1e3
            else:
                keep.append((phase, start, end))
        self._spans = keep

    # -------------------------------------------------------------- intake
    def submit(self, prompt, *, max_new_tokens: int = 16,
               temperature: float = 0.0, seed: int = 0,
               stop_tokens: Tuple[int, ...] = (),
               deadline_steps: Optional[int] = None) -> int:
        params = SamplingParams(max_new_tokens=max_new_tokens,
                                temperature=float(temperature),
                                seed=int(seed),
                                stop_tokens=tuple(int(t)
                                                  for t in stop_tokens))
        req = self.sched.submit(prompt, params,
                                deadline_steps=deadline_steps)
        self.requests[req.rid] = req
        return req.rid

    def status(self, rid: int) -> Tuple[str, Optional[str]]:
        req = self.requests[rid]
        return req.state, req.finish_reason

    # ------------------------------------------------------------- prefill
    def _chunk_pad(self, n: int) -> int:
        """Padded chunk length: the fixed chunk size, or (whole-prompt
        mode) ``n`` rounded up to the prefill bucket."""
        if self.prefill_chunk_tokens:
            return self.prefill_chunk_tokens
        b = self._prefill_bucket
        return max(b, -(-n // b) * b)

    def _nkv_for(self, end: int) -> int:
        """Block-table width of a chunk ending at context position ``end``,
        bucketed to ``_NKV_BUCKET`` blocks (the reference's jit shape
        bucket; kernel A sees keys past ``end`` and the causal mask with
        ``q_offset`` hides them)."""
        need = -(-end // self.cache.block_size)
        return min(self.cache.max_blocks_per_req,
                   -(-need // self._NKV_BUCKET) * self._NKV_BUCKET)

    def _chunk(self, table, start: int, n: int, tokens) -> None:
        """Forward one chunk ``tokens`` (1, C) at ``start`` with ``n`` valid
        rows through the block table row ``table`` (1, nkv)."""
        dev = self.device
        self.model.prefill_chunk(
            self.params, self._view(table),
            torch.as_tensor(tokens, device=dev), start, n)

    def _run_chunk(self, req: Request, start: int, n: int) -> None:
        """Forward context positions [start, start+n) of ``req`` and
        scatter their KV into the slot's blocks."""
        end = start + n
        toks = np.zeros((1, self._chunk_pad(n)), np.int64)
        toks[0, :n] = req.context[start:end]
        self._chunk(self.cache.table[req.slot:req.slot + 1,
                                     :self._nkv_for(end)], start, n, toks)
        self.counters["prefill_chunks"] += 1
        self.counters["prefill_tokens"] += n

    def warm_prefill(self, max_ctx: int) -> int:
        """Run every (chunk length, table width) shape a context of up to
        ``max_ctx`` tokens can reach once, as dummy chunks against an
        all-null table (writes land in the null block; no allocator state
        is touched): the kernels build and cuBLAS warms before serving.
        Returns the number of shapes (the reference's compile count)."""
        shapes = {(self._chunk_pad(min(e, self.prefill_chunk_tokens or e)),
                   self._nkv_for(e)) for e in range(1, max_ctx + 1)}
        for C, nkv in sorted(shapes):
            self._chunk(np.zeros((1, nkv), np.int32), 0, 0,
                        np.zeros((1, C), np.int64))
        return len(shapes)

    # -------------------------------------------------------------- decode
    def _rows(self, live: List[Request], T: int):
        """Host inputs of a decode or verify step over the fixed batch of
        ``max_batch`` rows: tokens (B, T), positions (B,) and the block
        table.  Non-live rows (idle slots, mid-prefill requests) run with
        pos = 0, token 0 and an all-null table row, so their KV writes land
        in the reserved null block."""
        B = self.max_batch
        tok = np.zeros((B, T), np.int64)
        pos = np.zeros((B,), np.int32)
        tbl = np.zeros_like(self.cache.table)
        for r in live:
            tok[r.slot, 0] = r.pending
            pos[r.slot] = r.cached
            tbl[r.slot] = self.cache.table[r.slot]
        return tok, pos, tbl

    def _view(self, tbl):
        """The model's view of the pools through block table ``tbl``."""
        view = {**self.cache.pools,
                "block_table": torch.as_tensor(tbl, device=self.device)}
        if self.cache.shard is not None:
            view["shard"] = self.cache.shard
        return view

    # ------------------------------------------------------ fault plumbing
    def _release_due_squeezes(self) -> None:
        keep = []
        for release_step, ids in self._squeezes:
            if self.step_idx >= release_step:
                self.cache.allocator.free(ids, FAULT_OWNER)
            else:
                keep.append((release_step, ids))
        self._squeezes = keep

    def release_faults(self) -> None:
        """Return every fault-held (squeezed) block to the pool — ``run``
        calls it when it drains; manual steppers call it before checking
        conservation at exit."""
        for _, ids in self._squeezes:
            self.cache.allocator.free(ids, FAULT_OWNER)
        self._squeezes = []

    def _apply_pre_plan_faults(self, events) -> Tuple[bool, list]:
        """Apply the squeeze / storm / slow / corrupt faults, which act on
        state the coming plan must see.  Returns (decode dropped, the
        nan_logits events)."""
        inj, drop, nan_events = self.injector, False, []
        for e in events:
            if e.kind == "squeeze":
                take = min(e.magnitude, self.cache.allocator.n_free)
                if take:
                    ids = self.cache.allocator.alloc(FAULT_OWNER, take)
                    self._squeezes.append((self.step_idx + e.duration, ids))
                    inj.fired(self.step_idx, e.kind,
                              f"held {take} blocks for {e.duration} steps")
                else:
                    inj.fired(self.step_idx, e.kind, "no free blocks")
            elif e.kind == "preempt_storm":
                victims = self.sched.force_preempt(e.magnitude)
                inj.fired(self.step_idx, e.kind,
                          f"preempted rids {[v.rid for v in victims]}")
            elif e.kind == "slow_step":
                self.sched.advance_clock(e.magnitude)
                inj.fired(self.step_idx, e.kind,
                          f"+{e.magnitude} clock ticks")
            elif e.kind == "corrupt_block":
                victim, block = self._corruption_victim(e)
                if victim is None:
                    inj.fired(self.step_idx, e.kind, "no candidate")
                else:
                    self.cache.corrupt_block(block)
                    inj.fired(self.step_idx, e.kind,
                              f"rid={victim.rid} block={block}")
            elif e.kind == "drop_step":
                drop = True
                inj.fired(self.step_idx, e.kind, "decode step dropped")
            elif e.kind == "nan_logits":
                nan_events.append(e)      # resolved once live rows known
        return drop, nan_events

    def _corruption_victim(self, event):
        """A decode-phase request's last block, owned by it alone (never a
        shared or prefix-indexed block: corruption poisons one request)."""
        cands = []
        for slot in sorted(self.sched.running):
            r = self.sched.running[slot]
            if r.cached < r.n_prefill:
                continue
            n = int(self.cache.n_assigned[slot])
            b = int(self.cache.table[slot, n - 1]) if n else 0
            if b and self.cache.allocator.owners(b) == (r.rid,):
                cands.append((r, b))
        pick = self.injector.pick(event, cands)
        return pick if pick is not None else (None, None)

    def _quarantine(self, req: Request, reason: str) -> None:
        """Terminally fail one request with non-finite logits: scrub its
        exclusively owned blocks, release its refs, keep its stream."""
        self.cache.scrub_slot(req.slot, req.rid)
        self.sched.fail(req, reason)
        self.counters["quarantined"] += 1

    def _release_draft(self, rid: int) -> None:
        """Terminal-state hook: drop the request's draft state and its
        adaptive-depth history."""
        if self.draft is not None:
            self.draft.release(rid)
        if self._adepth is not None:
            self._adepth.release(rid)

    # ---------------------------------------------------------- the loop
    def _emit(self, req: Request, token: int, events) -> None:
        req.emitted.append(int(token))
        events.setdefault(req.rid, []).append(int(token))
        if token in req.params.stop_tokens:
            self.sched.finish(req, "stop")
        elif len(req.emitted) >= req.params.max_new_tokens:
            self.sched.finish(req, "length")

    def step(self) -> Dict[int, List[int]]:
        """One engine step. Returns {rid: [tokens emitted this step]}."""
        self._fold_spans()
        self._release_due_squeezes()
        drop, nan_events = False, []
        if self.injector is not None:
            drop, nan_events = self._apply_pre_plan_faults(
                self.injector.events_for(self.step_idx))
        plan = self.sched.plan()
        events: Dict[int, List[int]] = {}
        for r in plan.expired:
            self._release_draft(r.rid)
        t0 = self._clock() if plan.chunks else None
        for req, start, n in plan.chunks:
            if req.state != PREFILL:       # preempted after planning
                continue
            self._run_chunk(req, start, n)
            req.cached = start + n
            if req.cached >= req.n_prefill:
                req.state = DECODE
            # index the newly completed full blocks for later arrivals
            self.cache.register_prefix(req.slot, req.rid, req.context,
                                       req.cached)
        if t0 is not None:
            self._span("prefill", t0)

        live = [r for r in plan.decode if r.state == DECODE]
        n_tokens = 0
        held = drop or self.step_idx < self._backoff_until
        if nan_events and (not live or held):
            for e in nan_events:
                self.injector.fired(self.step_idx, e.kind,
                                    "no live decode row")
            nan_events = []
        if live and held:
            # a dropped step (or the backoff window after one): nobody
            # advances, and the retry samples the same positions, so the
            # streams are unchanged; a request fails after max_retries
            if drop:
                self._consec_drops += 1
                self._backoff_until = self.step_idx + 1 + min(
                    2 ** (self._consec_drops - 1), self.backoff_cap)
                for r in live:
                    r.retries += 1
                    self.counters["retried"] += 1
                    if r.retries > self.max_retries:
                        self.sched.fail(r, "retries_exhausted")
                        self._release_draft(r.rid)
            else:
                self.counters["backoff_steps"] += 1
        elif live:
            poisoned = set()
            for e in nan_events:
                victim = self.injector.pick(
                    e, sorted(live, key=lambda r: r.rid))
                poisoned.add(victim.slot)
                self.injector.fired(self.step_idx, e.kind,
                                    f"rid={victim.rid}")
            t0 = self._clock()
            if self.spec is not None:
                n_tokens = self._spec_step(live, poisoned, events)
            else:
                n_tokens = self._decode_step(live, poisoned, events)
            self._span("decode", t0)
            self._consec_drops = 0
        self.counters["decode_tokens"] += n_tokens
        self.sched.record_progress(n_tokens)
        self.step_idx += 1
        if self.audit_mode:
            self.cache.audit(self.sched.running)
            self.counters["audit_passes"] += 1
        return events

    def _decode_step(self, live, poisoned, events) -> int:
        """One decode step and its sampling; rows in ``poisoned`` (slots of
        ``nan_logits`` faults) count as non-finite, as if NaN were added to
        their logits."""
        tok, pos, tbl = self._rows(live, 1)
        B = self.max_batch
        temps = np.zeros((B,), np.float32)
        seeds = np.zeros((B,), np.int64)
        for r in live:
            temps[r.slot] = r.params.temperature
            seeds[r.slot] = r.params.seed
        dev = self.device
        logits = self.model.decode(self.params, self._view(tbl),
                                   torch.as_tensor(tok, device=dev),
                                   torch.as_tensor(pos, device=dev))
        lf = logits[:, -1].float()
        ok = torch.isfinite(lf).all(dim=-1).cpu().numpy()
        ok[list(poisoned)] = False
        # the sampled token sits at context position cached + 1
        nxt = _sample(torch.nan_to_num(lf), temps, seeds, pos + 1)
        self.counters["decode_steps"] += 1
        n_tokens = 0
        for r in live:
            if not ok[r.slot]:
                # quarantine exactly this row; its clean prefix is kept
                # and everyone else streams on
                self._quarantine(r, "nan_logits")
                continue
            r.retries = 0
            r.cached += 1
            self._emit(r, int(nxt[r.slot]), events)
            n_tokens += 1
        return n_tokens

    def _spec_step(self, live, poisoned, events) -> int:
        """One speculative step over the live rows: draft, verify, walk.
        The verify shape is fixed at T = 1 + depth: short proposal lists
        are padded, ``n_write`` sends the padding rows' KV to the null
        block and the walk never reads their samples."""
        T = 1 + self.spec.depth
        tok, pos, tbl = self._rows(live, T)
        n_write = np.zeros((self.max_batch,), np.int32)
        props: Dict[int, List[int]] = {}
        for r in live:
            k = self.sched.spec_budget(r)
            if self._adepth is not None:
                k = min(k, self._adepth.depth_for(r.rid))
            k = max(k, 0)
            self.spec_depth_hist[k] = self.spec_depth_hist.get(k, 0) + 1
            pr = [int(t) for t in self.draft.propose(r, k)][:k]
            props[r.rid] = pr
            tok[r.slot, 1:1 + len(pr)] = pr
            n_write[r.slot] = 1 + len(pr)
        dev = self.device
        logits = self.model.verify(
            self.params, self._view(tbl), torch.as_tensor(tok, device=dev),
            torch.as_tensor(pos, device=dev),
            torch.as_tensor(n_write, device=dev))
        lf = logits.float()
        ok = torch.isfinite(lf).all(dim=-1).cpu().numpy()       # (B, T)
        ok[list(poisoned)] = False
        greedy = lf.argmax(dim=-1).cpu().numpy()                 # (B, T)
        hot = [r.slot for r in live if r.params.temperature > 0]
        rows = dict(zip(hot, lf[hot].cpu().numpy())) if hot else {}
        self.counters["decode_steps"] += 1
        n_tokens = 0
        for r in live:
            pr = props[r.rid]
            if not ok[r.slot, :1 + len(pr)].all():
                # non-finite in any row the walk could read: quarantine
                self._quarantine(r, "nan_logits")
                self._release_draft(r.rid)
                continue
            r.retries = 0
            n_acc = 0
            for i in range(len(pr) + 1):
                # the target's own sample for position cached + 1 + i, as
                # i sequential decode steps would draw it
                p_i = int(pos[r.slot]) + 1 + i
                t_i = (_draw(rows[r.slot][i], r.params.temperature,
                             r.params.seed, p_i) if r.slot in rows
                       else int(greedy[r.slot, i]))
                r.cached += 1
                self._emit(r, t_i, events)
                n_tokens += 1
                acc = i < len(pr) and pr[i] == t_i
                n_acc += acc
                if r.state != DECODE or not acc:
                    break
            # rejected rows need no undo: cached did not advance over
            # them, and their KV sits masked in blocks this request owns
            self.counters["spec_proposed"] += len(pr)
            self.counters["spec_accepted"] += n_acc
            self.counters["spec_rejected"] += len(pr) - n_acc
            if len(pr) > n_acc:
                self.counters["spec_rollbacks"] += 1
            if self._adepth is not None:
                self._adepth.observe(r.rid, n_acc, len(pr))
            if r.done:
                self._release_draft(r.rid)
            else:
                self.draft.observe(r, n_acc, len(pr))
        return n_tokens

    def run(self, max_steps: int = 100_000) -> Dict[int, np.ndarray]:
        """Drive ``step`` until every request is terminal, then release the
        fault-held blocks; returns {rid: emitted token array}."""
        for _ in range(max_steps):
            if self.sched.idle:
                break
            self.step()
        else:
            raise RuntimeError("engine did not drain (scheduling bug?)")
        self.release_faults()
        return {rid: np.asarray(r.emitted, np.int32)
                for rid, r in self.requests.items()}

    def stream(self, rid: int):
        """Yield ``rid``'s tokens as they are produced (drives step())."""
        req = self.requests[rid]
        emitted = 0
        while True:
            while emitted < len(req.emitted):
                yield req.emitted[emitted]
                emitted += 1
            if req.done:
                break
            self.step()

    def generate(self, batch, n_tokens: int,
                 temperature: float = 0.0) -> np.ndarray:
        """Submit every row of ``batch["tokens"]`` (row b with seed b),
        drain, return (B, n_tokens) tokens."""
        toks = np.asarray(batch["tokens"])
        rids = [self.submit(toks[b], max_new_tokens=n_tokens,
                            temperature=float(temperature), seed=b)
                for b in range(toks.shape[0])]
        out = self.run()
        return np.stack([out[r][:n_tokens] for r in rids])

    # ---------------------------------------------------------- telemetry
    def stats(self) -> dict:
        """One flat dict: scheduler occupancy, pool and prefix-cache
        counters, the robustness and speculative counters, the injected
        faults by kind, and the phase seconds."""
        self._fold_spans(wait=True)
        sc = self.sched.counters
        out = {
            "n_preemptions": self.sched.n_preemptions,
            "steps": self.sched.step_count,
            "running": len(self.sched.running),
            "waiting": len(self.sched.waiting),
            "free_blocks": self.cache.allocator.n_free,
            "usable_blocks": self.cache.allocator.n_usable,
            "cache_blocks": self.cache.n_cache_blocks,
            **self.cache.counters,
            "shed": sc["shed"], "expired": sc["expired"],
            "failed": sc["failed"],
            "storm_preempts": sc["storm_preempts"],
            "watchdog_trips": sc["watchdog_trips"],
            "serial_admission": self.sched.serial_admission,
            **self.counters,
            "spec_acceptance": (self.counters["spec_accepted"]
                                / max(self.counters["spec_proposed"], 1)),
            "spec_depth_hist": dict(sorted(self.spec_depth_hist.items())),
            "prefill_seconds": self.seconds["prefill"],
            "decode_seconds": self.seconds["decode"],
        }
        if self.injector is not None:
            out["faults"] = dict(self.injector.counts)
        if self.cache.prefix is not None:
            out["prefix_cache"] = dict(self.cache.prefix.stats)
        return out


# dense-cache keys whose sequence axis (2) gets decode headroom padding
_PAD_KEYS = ("k", "v", "ckv")


class FixedSlotEngine:
    """Batched fixed-slot serving: one prefill plus a dense contiguous KV
    cache, stepped one token at a time, with per-request ``(B,)``
    positions.  The cache is padded with ``n_tokens`` of headroom, rounded
    up so that the padded length divides over the cache's sequence shards
    (``model.pad_cache``), so the ring buffer never wraps.

    On a mesh every rank calls :meth:`generate` with the same batch; the
    prefill runs across the sequence ranks under ``par.schedule`` (on a 2D
    mesh the 2D plan over the (seq, head) pair) and each decode step
    reduces over the cache's shards (``par.seq_axes``), so every rank
    returns the same tokens.  An MLA / MoE model keeps the latent rows ``{"ckv"}`` as
    its cache; across ranks its routed experts shard over the ``model``
    ranks (the prefill dispatches over them, each decode step sums their
    outputs).  A VLM's batch adds ``image_embeds`` and an
    encoder–decoder's ``frames``, which go to the prefill beside the
    tokens; the prompt's length S0 is the cache's, so a VLM's counts its
    image rows, as the reference's does."""

    def __init__(self, model, params):
        self.model = model
        self.params = params

    def generate(self, batch, n_tokens: int, rng=None,
                 temperature: float = 0.0):
        """``batch["tokens"]`` (B, T): the prompts (and a VLM's
        ``image_embeds`` / an encoder–decoder's ``frames``).  Returns
        (tokens (B, n_tokens) int32, last logits (B, 1, V)).  Greedy, or at
        ``temperature > 0`` with a key ``rng`` (``prng.prng_key(seed)``)
        the reference's draws: ``rng, k = split(rng)`` then
        ``categorical(k, logits / temperature)`` each step."""
        model = self.model
        dev = model.device
        extra = {k: batch[k] for k in ("image_embeds", "frames")
                 if k in batch}
        logits, cache = model.prefill(self.params, batch["tokens"], **extra)
        if not any(k in cache for k in _PAD_KEYS):
            raise ValueError("FixedSlotEngine serves attention-cache "
                             "decoders only")
        # the cache's length: this rank's shard of the prompt's slots
        S0 = next(cache[k].shape[2] for k in _PAD_KEYS
                  if k in cache) * model.seq_size
        grp = model.decode_group
        n_sh = 1 if grp is None else grp.size
        pad = -(-(S0 + n_tokens) // n_sh) * n_sh - S0
        cache = model.pad_cache(cache, S0 + pad)
        B = logits.shape[0]
        tok = logits[:, -1].float().argmax(dim=-1)[:, None].to(torch.int32)
        outs = []
        for i in range(n_tokens):
            outs.append(tok)
            pos = torch.full((B,), S0 + i, dtype=torch.int32, device=dev)
            logits = model.decode(self.params, cache, tok, pos)
            lf = logits[:, -1].float()
            if temperature > 0 and rng is not None:
                keys = prng.split(rng)
                rng, k = keys[0], keys[1]
                draw = prng.categorical(k, lf.cpu().numpy()
                                        / np.float32(temperature))
                tok = torch.as_tensor(draw, dtype=torch.int32,
                                      device=dev)[:, None]
            else:
                tok = lf.argmax(dim=-1)[:, None].to(torch.int32)
        return torch.cat(outs, dim=1), logits

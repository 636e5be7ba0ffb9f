"""Serving engines (port of the reference ``serve/engine.py``: ``Engine``,
without speculative decoding and fault injection, and ``FixedSlotEngine``).

:class:`Engine` is the paged continuous-batching engine:

  * ``submit(prompt, max_new_tokens=…, temperature=…, seed=…,
    stop_tokens=…, deadline_steps=…) -> rid`` — enqueue a request; the
    scheduler may shed it (terminal ``REJECTED`` with a reason);
  * ``step() -> {rid: [new tokens]}`` — one engine step: admit waiting
    requests (sharing prefix-cache blocks), run each mid-prefill request's
    next chunk (``model.prefill_chunk`` writes straight into pool blocks;
    kernel A attends), then ONE decode step over the decode-ready slots
    (per-request positions, kernel B attends through the block table) and
    sampling;
  * ``stream(rid)`` / ``run()`` / ``generate()`` — drive ``step``;
  * ``stats()`` — counters, and the seconds spent in prefill chunks and in
    decode steps (on a CUDA device, CUDA events around each phase, read
    only once they have completed, so timing adds no sync to the loop).

The pending-token design is the reference's: prefill covers
``context[:-1]`` and the last context token enters through decode, so
prefill never computes logits and chunks can be bucket-padded (padded rows
write to the null block).  Preemption is recompute-style.  A decode row
with non-finite logits is quarantined (terminal ``FAILED``) while the rest
of the batch streams on.

Sampling: greedy at temperature 0; otherwise the reference's draw,
``categorical(fold_in(PRNGKey(seed), position), logits / T)``, reproduced
on the host by :mod:`repro_torch.serve.prng` (threefry2x32 keys and bits,
Gumbel-max) — so a request's stream depends only on its own (prompt,
params), never on the batch around it, is the same on every device, and is
the reference's stream token for token.

:class:`FixedSlotEngine` is one prefill plus a dense cache stepped one token
at a time — the reference's dense-cache oracle of the paged engine, and its
long-context path: on a mesh the prompt is prefilled across the sequence
ranks and the cache stays sharded along the sequence, every rank running
the same decode loop (flash-decoding across the shards).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serve import prng
from repro_torch.serve.cache import PagedKVCache
from repro_torch.serve.scheduler import (DECODE, PREFILL, Request,
                                         SamplingParams, Scheduler)


def _sample(logits, temps, seeds, positions) -> np.ndarray:
    """Per-row sampling of ``logits`` (B, V) float32: greedy where
    ``temps[b] == 0``, else the reference's categorical draw of
    ``logits / T`` under ``fold_in(PRNGKey(seeds[b]), positions[b])``."""
    out = logits.argmax(dim=-1).to(torch.int32).cpu().numpy()
    hot = [b for b in range(len(temps)) if temps[b] > 0]
    if hot:
        rows = logits[hot].float().cpu().numpy()
        for i, b in enumerate(hot):
            key = prng.fold_in(prng.prng_key(seeds[b]), positions[b])
            t = np.maximum(np.float32(temps[b]), np.float32(1e-6))
            out[b] = int(prng.categorical(key, rows[i] / t))
    return out


class Engine:
    """Paged continuous-batching serving engine (see module docstring)."""

    _NKV_BUCKET = 4          # table-width bucket of a prefill chunk

    def __init__(self, model, params, *, max_batch: int = 8,
                 block_size: Optional[int] = None, n_blocks: int = 128,
                 max_blocks_per_req: Optional[int] = None,
                 prefill_chunk_tokens: int = 32,
                 prefix_cache: bool = True,
                 max_queue: Optional[int] = None,
                 admit_watermark: float = 0.0,
                 watchdog_window: int = 8,
                 watchdog_threshold: int = 3,
                 audit: bool = False,
                 record_logits: bool = False):
        cfg = model.cfg
        self.model = model
        self.params = params
        self.cfg = cfg
        self.device = model.device
        self.cache = PagedKVCache.create(
            cfg, block_size=block_size, n_blocks=n_blocks,
            max_reqs=max_batch, max_blocks_per_req=max_blocks_per_req,
            prefix_cache=prefix_cache, device=self.device,
            dtype=model.dtype)
        self.sched = Scheduler(self.cache, max_batch,
                               prefill_chunk_tokens=prefill_chunk_tokens,
                               max_queue=max_queue,
                               admit_watermark=admit_watermark,
                               watchdog_window=watchdog_window,
                               watchdog_threshold=watchdog_threshold)
        self.max_batch = max_batch
        self.prefill_chunk_tokens = int(prefill_chunk_tokens)
        self.requests: Dict[int, Request] = {}
        self.audit_mode = bool(audit)
        # last decode logits per request (float32, on the device) — lets a
        # caller hold the paged path against a plain forward
        self.record_logits = bool(record_logits)
        self.last_logits: Dict[int, torch.Tensor] = {}
        self.counters = dict(quarantined=0, audit_passes=0,
                             prefill_chunks=0, prefill_tokens=0,
                             decode_steps=0, decode_tokens=0)
        self.seconds = dict(prefill=0.0, decode=0.0)
        self._spans: List[tuple] = []      # (phase, start, end) events

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
        mode) ``n`` rounded up to the block size."""
        if self.prefill_chunk_tokens:
            return self.prefill_chunk_tokens
        b = self.cache.block_size
        return max(b, -(-n // b) * b)

    def _nkv_for(self, end: int) -> int:
        """Block-table width of a chunk ending at context position ``end``,
        bucketed to ``_NKV_BUCKET`` blocks (the reference's jit shape
        bucket; kernel A sees keys past ``end`` and the causal mask with
        ``q_offset`` hides them)."""
        need = -(-end // self.cache.block_size)
        return min(self.cache.max_blocks_per_req,
                   -(-need // self._NKV_BUCKET) * self._NKV_BUCKET)

    def _run_chunk(self, req: Request, start: int, n: int) -> None:
        """Forward context positions [start, start+n) of ``req`` and
        scatter their KV into the slot's blocks."""
        end = start + n
        C = self._chunk_pad(n)
        toks = np.zeros((1, C), np.int64)
        toks[0, :n] = req.context[start:end]
        nkv = self._nkv_for(end)
        bt = torch.as_tensor(self.cache.table[req.slot:req.slot + 1, :nkv],
                             device=self.device)
        self.model.prefill_chunk(
            self.params, {**self.cache.pools, "block_table": bt},
            torch.as_tensor(toks, device=self.device), start, n)
        self.counters["prefill_chunks"] += 1
        self.counters["prefill_tokens"] += n

    # -------------------------------------------------------------- decode
    def _decode(self, live: List[Request]):
        """One decode step over the fixed batch of ``max_batch`` rows.
        Non-live rows (idle slots and mid-prefill requests) run with
        pos = 0, token 0 and an all-null table row, so their KV writes land
        in the reserved null block."""
        B = self.max_batch
        tok = np.zeros((B, 1), np.int64)
        pos = np.zeros((B,), np.int32)
        tbl = np.zeros_like(self.cache.table)
        temps = np.zeros((B,), np.float32)
        seeds = np.zeros((B,), np.int64)
        for r in live:
            tok[r.slot, 0] = r.pending
            pos[r.slot] = r.cached
            tbl[r.slot] = self.cache.table[r.slot]
            temps[r.slot] = r.params.temperature
            seeds[r.slot] = r.params.seed
        dev = self.device
        logits = self.model.decode(
            self.params,
            {**self.cache.pools, "block_table": torch.as_tensor(tbl,
                                                                device=dev)},
            torch.as_tensor(tok, device=dev), torch.as_tensor(pos,
                                                              device=dev))
        lf = logits[:, -1].float()
        ok = torch.isfinite(lf).all(dim=-1).cpu().numpy()
        # the sampled token sits at context position cached + 1
        nxt = _sample(torch.nan_to_num(lf), temps, seeds, pos + 1)
        if self.record_logits:
            for r in live:
                self.last_logits[r.rid] = lf[r.slot].clone()
        self.counters["decode_steps"] += 1
        return nxt, ok

    # ---------------------------------------------------------- the loop
    def _emit(self, req: Request, token: int, events) -> None:
        req.emitted.append(int(token))
        events.setdefault(req.rid, []).append(int(token))
        if token in req.params.stop_tokens:
            self.sched.finish(req, "stop")
        elif len(req.emitted) >= req.params.max_new_tokens:
            self.sched.finish(req, "length")

    def _quarantine(self, req: Request, reason: str) -> None:
        """Terminally fail one request with non-finite logits: scrub its
        exclusively owned blocks, release its refs, keep its stream."""
        self.cache.scrub_slot(req.slot, req.rid)
        self.sched.fail(req, reason)
        self.counters["quarantined"] += 1

    def step(self) -> Dict[int, List[int]]:
        """One engine step. Returns {rid: [tokens emitted this step]}."""
        self._fold_spans()
        plan = self.sched.plan()
        events: Dict[int, List[int]] = {}
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
        if live:
            t0 = self._clock()
            nxt, ok = self._decode(live)
            self._span("decode", t0)
            for r in live:
                if not ok[r.slot]:
                    self._quarantine(r, "nan_logits")
                    continue
                r.cached += 1
                self._emit(r, int(nxt[r.slot]), events)
                n_tokens += 1
        self.counters["decode_tokens"] += n_tokens
        self.sched.record_progress(n_tokens)
        if self.audit_mode:
            self.cache.audit(self.sched.running)
            self.counters["audit_passes"] += 1
        return events

    def run(self, max_steps: int = 100_000) -> Dict[int, np.ndarray]:
        """Drive ``step`` until every request is terminal; returns {rid:
        emitted token array}."""
        for _ in range(max_steps):
            if self.sched.idle:
                break
            self.step()
        else:
            raise RuntimeError("engine did not drain (scheduling bug?)")
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
            "failed": sc["failed"], "watchdog_trips": sc["watchdog_trips"],
            **self.counters,
            "prefill_seconds": self.seconds["prefill"],
            "decode_seconds": self.seconds["decode"],
        }
        if self.cache.prefix is not None:
            out["prefix_cache"] = dict(self.cache.prefix.stats)
        return out


class FixedSlotEngine:
    """Batched fixed-slot serving: one prefill plus a dense contiguous KV
    cache, stepped one token at a time, with per-request ``(B,)``
    positions.  The cache is padded with ``n_tokens`` of headroom, rounded
    up so that the padded length divides over the cache's sequence shards
    (``model.pad_cache``), so the ring buffer never wraps.

    On a mesh every rank calls :meth:`generate` with the same batch; the
    prefill runs across the ``model`` ranks under ``par.schedule`` and each
    decode step reduces over the cache's shards, so every rank returns the
    same tokens."""

    def __init__(self, model, params):
        self.model = model
        self.params = params

    def generate(self, batch, n_tokens: int, rng=None,
                 temperature: float = 0.0):
        """``batch["tokens"]`` (B, T): the prompts.  Returns (tokens
        (B, n_tokens) int32, last logits (B, 1, V)).  Greedy, or at
        ``temperature > 0`` with a key ``rng`` (``prng.prng_key(seed)``)
        the reference's draws: ``rng, k = split(rng)`` then
        ``categorical(k, logits / temperature)`` each step."""
        model = self.model
        dev = model.device
        logits, cache = model.prefill(self.params, batch["tokens"])
        S0 = int(np.asarray(batch["tokens"]).shape[1])
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

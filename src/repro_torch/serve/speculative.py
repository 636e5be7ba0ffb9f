"""Speculative decoding: draft sources and the acceptance rule (port of the
reference ``serve/speculative.py``).

With ``Engine(spec=SpecConfig(...))`` the one-token decode becomes a
*verify* pass: a draft source proposes up to ``depth`` next tokens for each
decode-ready request, the target scores the pending token plus every
proposal in one multi-token forward over the paged cache
(``DecoderLM.verify``: the rows' K/V written, then kernel B attends at
Tq = depth + 1), and a walk commits the longest prefix of proposals the
target itself would have sampled, plus one target-sampled token.

**Determinism.**  The token at context position ``p`` is sampled under
``fold_in(PRNGKey(seed), p)`` from the logits at ``p``.  The verify pass
computes those per-position samples for all rows at once, and a proposal is
accepted iff it equals the target's own sample at its position — so the
emitted stream is the non-speculative engine's whatever the draft
proposes; a draft changes how many tokens commit a step, never which.
Rejected rows roll back by not advancing ``Request.cached``: their KV sits
above the valid length in blocks the request owns alone
(``Scheduler.spec_budget`` reserved them), masked until overwritten.

Draft sources:

  * :class:`NGramDraft` — prompt-lookup self-speculation: the
    continuation of the most recent earlier occurrence of the context's
    longest trailing n-gram.  Stateless.
  * :class:`ModelDraft` — a paired smaller model (``smollm-360m`` for
    ``llama-7b``, ``configs/spec_pairs.py``) with its own paged cache,
    caught up with ``prefill_chunk`` (kernel A) and rolled ``k`` greedy
    ``decode`` steps ahead (kernel B).  Pool exhaustion degrades to
    proposing nothing.
  * :class:`NullDraft` — proposes nothing; at ``depth=0`` the verify pass
    is a single-row tree and equals vanilla decode.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.serve.cache import PagedKVCache, PoolExhausted

_MODES = ("none", "ngram", "model")


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding knobs.

    ``depth``: most draft tokens verified a step (0 keeps the verify path
    with no drafts).  ``mode``: ``"ngram"``, ``"model"`` (pass the engine a
    :class:`ModelDraft`) or ``"none"``.  ``ngram``: the longest n-gram the
    prompt-lookup matcher tries.  ``adaptive`` turns on
    :class:`AdaptiveDepth`: a request's draft budget shrinks from ``depth``
    toward ``min_depth`` as its acceptance over its last ``adapt_window``
    verify steps drops; ``adapt_floor`` is the least expected acceptance
    probability worth proposing a position for.  The verify shape stays
    ``1 + depth``."""
    depth: int = 4
    mode: str = "ngram"
    ngram: int = 3
    draft_arch: Optional[str] = None   # bookkeeping: which zoo config
    adaptive: bool = False
    adapt_window: int = 8
    adapt_floor: float = 0.25
    min_depth: int = 1

    def __post_init__(self):
        if self.depth < 0:
            raise ValueError("depth must be >= 0")
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}")
        if self.ngram < 1:
            raise ValueError("ngram must be >= 1")
        if self.adapt_window < 1:
            raise ValueError("adapt_window must be >= 1")
        if not 0.0 < self.adapt_floor < 1.0:
            raise ValueError("adapt_floor must be in (0, 1)")
        if not 0 <= self.min_depth <= max(self.depth, 1):
            raise ValueError("min_depth must be in [0, depth]")


class AdaptiveDepth:
    """Acceptance-aware per-request draft budget: from a request's windowed
    acceptance rate ``a`` over its last ``adapt_window`` verify steps, the
    i-th draft position commits with probability ``a^i``, so positions past
    ``floor(log(adapt_floor) / log(a))`` are not proposed; clamped to
    ``[min_depth, depth]``, the full cap with no history yet.  A pure
    function of the request's own history, so streams stay batch- and
    preemption-invariant."""

    def __init__(self, spec: SpecConfig):
        self.cap = spec.depth
        self.min_depth = min(spec.min_depth, spec.depth)
        self.window = spec.adapt_window
        self.floor = spec.adapt_floor
        self._hist: Dict[int, deque] = {}

    def depth_for(self, rid: int) -> int:
        h = self._hist.get(rid)
        if not h:
            return self.cap
        prop = sum(p for _, p in h)
        acc = sum(a for a, _ in h)
        if prop <= 0 or acc >= prop:
            return self.cap
        if acc <= 0:
            return self.min_depth
        d = int(math.log(self.floor) / math.log(acc / prop))
        return max(self.min_depth, min(self.cap, d))

    def observe(self, rid: int, n_acc: int, proposed: int) -> None:
        if proposed <= 0:
            return                      # nothing proposed: no signal
        self._hist.setdefault(rid, deque(maxlen=self.window)).append(
            (n_acc, proposed))

    def release(self, rid: int) -> None:
        self._hist.pop(rid, None)


class DraftSource:
    """The interface the engine drives each speculative step."""

    def propose(self, req, k: int) -> List[int]:
        """Up to ``k`` draft tokens continuing ``req.context``: a function
        of the request's own state, never of the batch around it."""
        raise NotImplementedError

    def observe(self, req, n_acc: int, proposed: int) -> None:
        """``n_acc`` of ``proposed`` drafts were accepted (the target also
        committed one more token)."""

    def release(self, rid: int) -> None:
        """The request is terminal: drop its draft state."""


class NullDraft(DraftSource):
    def propose(self, req, k: int) -> List[int]:
        return []


class NGramDraft(DraftSource):
    """Prompt-lookup self-speculation: the continuation of the most recent
    earlier occurrence of the context's longest trailing n-gram."""

    def __init__(self, ngram: int = 3):
        if ngram < 1:
            raise ValueError("ngram must be >= 1")
        self.ngram = int(ngram)

    def propose(self, req, k: int) -> List[int]:
        if k <= 0:
            return []
        ctx = np.asarray(req.context)
        L = len(ctx)
        for n in range(min(self.ngram, L - 1), 0, -1):
            # every earlier start s (s + n <= L - 1) at once; the rightmost
            # occurrence is the freshest continuation, never empty
            win = np.lib.stride_tricks.sliding_window_view(ctx[:L - 1], n)
            hit = np.flatnonzero((win == ctx[L - n:]).all(axis=1))
            if hit.size:
                s = int(hit[-1])
                return [int(t) for t in ctx[s + n:s + n + k]]
        return []


class ModelDraft(DraftSource):
    """A paired draft model with its own paged cache and block tables,
    caught up to each request's context with ``prefill_chunk`` and rolled
    ``k`` tokens ahead with greedy ``decode`` steps (B = 1 a request, so
    proposals depend on the request alone).

    ``_dlen[rid]`` counts the draft-cache positions that hold committed
    context KV; rejected draft KV above it is masked until overwritten.
    Pool exhaustion at admission proposes nothing for that request: the
    draft never preempts or stalls the target."""

    _PAD = 32                                     # catch-up chunk length

    def __init__(self, model, params, *, block_size: int = 16,
                 n_blocks: int = 128, max_batch: int = 8):
        self.model = model
        self.params = params
        self.cache = PagedKVCache.create(
            model.cfg, block_size=block_size, n_blocks=n_blocks,
            max_reqs=max_batch, prefix_cache=False, device=model.device,
            dtype=model.dtype)
        self.max_batch = int(max_batch)
        self._slots: Dict[int, int] = {}           # rid -> draft slot
        self._dlen: Dict[int, int] = {}            # rid -> cached positions

    def release(self, rid: int) -> None:
        slot = self._slots.pop(rid, None)
        self._dlen.pop(rid, None)
        if slot is not None:
            self.cache.release(slot, rid)

    def _ensure_slot(self, req, k: int) -> Optional[int]:
        rid = req.rid
        if rid in self._slots:
            return self._slots[rid]
        used = set(self._slots.values())
        slot = next((s for s in range(self.max_batch) if s not in used),
                    None)
        if slot is None:
            return None
        total = len(req.prompt) + req.params.max_new_tokens + k + 1
        try:
            self.cache.assign(slot, rid, total)
        except PoolExhausted:
            return None
        self._slots[rid] = slot
        self._dlen[rid] = 0
        return slot

    def propose(self, req, k: int) -> List[int]:
        if k <= 0:
            return []
        slot = self._ensure_slot(req, k)
        if slot is None:
            return []
        ctx = np.asarray(req.context)
        L = len(ctx)
        dev = self.model.device
        view = {**self.cache.pools, "block_table": torch.as_tensor(
            self.cache.table[slot:slot + 1], device=dev)}
        # catch up: prefill context[dlen : L-1]; the pending token's KV is
        # written by the first decode step, as in the target engine
        start = self._dlen[req.rid]
        while start < L - 1:
            n = min(L - 1 - start, self._PAD)
            toks = np.zeros((1, self._PAD), np.int64)
            toks[0, :n] = ctx[start:start + n]
            self.model.prefill_chunk(self.params, view,
                                     torch.as_tensor(toks, device=dev),
                                     start, n)
            start += n
        # roll k greedy steps ahead; the tokens stay on the device until
        # the last one
        tok = torch.full((1, 1), int(ctx[-1]), dtype=torch.int64,
                         device=dev)
        out = []
        for i in range(k):
            pos = torch.full((1,), L - 1 + i, dtype=torch.int32, device=dev)
            logits = self.model.decode(self.params, view, tok, pos)
            tok = logits[:, -1].argmax(dim=-1, keepdim=True)
            out.append(tok)
        # positions [0, L) now hold committed-context KV; draft KV above L
        # is provisional until observe() extends validity
        self._dlen[req.rid] = L
        return [int(t) for t in torch.cat(out, dim=1)[0].tolist()]

    def observe(self, req, n_acc: int, proposed: int) -> None:
        if proposed == 0 or req.rid not in self._slots:
            return            # no roll happened: the draft cache is as it was
        # accepted drafts are committed tokens, so their KV from the roll is
        # context KV now; the one extra target token is the new pending
        # token, whose KV the next roll writes
        self._dlen[req.rid] = len(req.context) - 1


def make_draft(spec: SpecConfig) -> DraftSource:
    """The engine's draft for the stateless modes; ``"model"`` needs the
    caller's :class:`ModelDraft`."""
    if spec.mode == "ngram":
        return NGramDraft(spec.ngram)
    if spec.mode == "none":
        return NullDraft()
    raise ValueError('mode="model" needs an explicit ModelDraft '
                     '(draft params are caller-owned)')

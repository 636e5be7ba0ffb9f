"""Paged KV cache: a fixed pool of ``block_size``-token KV blocks plus
per-request block tables — the serving-side analogue of the paper's
memory-efficiency discipline (no O(max_seq · max_batch) contiguous cache;
fragmentation-free growth one block at a time).

Layout (one pool entry per transformer layer, stacked on a leading L dim):

  k_pool, v_pool : (L, N, block_size, n_kv_heads, head_dim)
  MLA latent     : ckv_pool (L, N, block_size, kv_lora + rope_dim)

Block id 0 is the **reserved null block**: unused table entries and idle
batch rows point at it, so gathers are always in-bounds and garbage is
masked by ``lengths`` (kernels/paged.py).  The :class:`BlockAllocator`
free-list therefore hands out ids ``1..N−1`` and enforces the allocator
invariants the test suite checks (no double-alloc, owner-checked frees,
conservation, deterministic exhaustion).

**Content addressing / copy-on-write** (vLLM-style prefix caching): blocks
are *refcounted* — several owners (request ids, plus the cache's own
sentinel owner) may hold the same block, and it returns to the free list
only when the last ref drops.  :class:`PrefixCache` indexes *full* blocks
in a radix trie over token prefixes, each node carrying a chained content
hash ``H(parent_hash, block_tokens, salt)`` where the salt is the
MaskSpec-relevant config (block size, sliding window).  Admission looks up
the longest cached prefix (including a *partial tail* match inside the
last block) and shares those blocks instead of re-prefilling them; a
writer forks a private copy of a shared block only on first divergence
(:meth:`PagedKVCache.ensure_writable`).  Windowed requests additionally
*reclaim* blocks that fall wholly outside the sliding window
(:meth:`PagedKVCache.reclaim_window`) instead of merely masking them.

The pools are torch tensors, updated in place by the model (``index_put_``)
and by the copy-on-write fork here.  Sharding (``create(mesh=, seq_axis=)``,
the reference's ``_pool_pspec`` choice): over the ranks of the mesh axis,
the kv-head axis of a k / v pool shards when the head count divides it
(``"heads"``: head-parallel decode, each rank's query heads read only its
own pool), otherwise the pool-block axis (``"blocks"``: rank r holds
blocks ``[r·N/n, (r+1)·N/n)``; always for an MLA latent pool, which has
one kv head), otherwise the pool is replicated.  Each rank allocates only
its part (:class:`PoolShard` says which); :func:`sharded_paged_attn` and
:func:`sharded_latent_attn` attend over such a pool.  The math is the same
in all three placements.  The allocator, the prefix trie and the tables are
the same on every rank (every rank runs the same steps); a fork, a scrub or
a corruption touches the pool on the rank that holds the block, and a fork
across two ranks broadcasts the source block from its owner.  On a 2D
(seq, head) mesh the axis is ``seq`` alone: each head index has its own
seq Comm (``mesh.comms["seq"]``), so the u head ranks of a seq shard hold
the same part and run the same writes, forks and broadcasts, bitwise
alike.

The block *tables* are host-side numpy (the scheduler mutates them every
step); a device copy ships with each decode step's inputs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.attention import paged_decode_attn
from repro_torch.core.config import ModelConfig
from repro_torch.serve.faults import AuditFailure


class PoolExhausted(RuntimeError):
    """No free blocks — the scheduler preempts and requeues on this."""


@dataclasses.dataclass(frozen=True)
class PoolShard:
    """This rank's part of a sharded pool: ``kind`` ``"heads"`` (kv heads
    ``[lo, lo + n_local)``) or ``"blocks"`` (pool blocks ``[lo, lo +
    n_local)``), over the ranks of ``group`` (the mesh axis's Comm)."""
    kind: str
    group: object
    n_local: int

    @property
    def lo(self) -> int:
        return self.group.rank * self.n_local


class BlockAllocator:
    """Host-side refcounted free-list over block ids ``1..n_blocks−1``
    (0 = null).

    LIFO free-list with deterministic order: the same alloc/share/free
    sequence always yields the same block ids (batch-invariance tests rely
    on the *masking*, not the placement — but determinism keeps runs
    replayable).  Every op is owner-checked: an owner (a request id, or
    the prefix cache's sentinel) can hold at most one ref per block, a
    free by a non-owner raises, and a block returns to the free list
    exactly when its last owner releases it.
    """

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError("need at least 2 blocks (one is the reserved "
                             "null block)")
        self.n_blocks = n_blocks
        self._free: List[int] = list(range(n_blocks - 1, 0, -1))
        self._owners: Dict[int, Set[int]] = {}

    @property
    def n_usable(self) -> int:
        return self.n_blocks - 1

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, owner: int, n: int = 1) -> List[int]:
        """Allocate ``n`` fresh blocks for ``owner`` (a request id) —
        atomic: raises :class:`PoolExhausted` without side effects if
        fewer than ``n`` are free."""
        if len(self._free) < n:
            raise PoolExhausted(
                f"need {n} blocks, {len(self._free)} free "
                f"(pool {self.n_usable})")
        ids = [self._free.pop() for _ in range(n)]
        for b in ids:
            assert b not in self._owners         # free-list integrity
            self._owners[b] = {owner}
        return ids

    def share(self, ids: Sequence[int], owner: int) -> None:
        """Add ``owner`` as a referent of already-allocated blocks
        (content-addressed reuse).  Sharing a free block, or a block the
        owner already holds, raises."""
        for b in ids:
            owners = self._owners.get(b)
            if owners is None:
                raise ValueError(f"cannot share free block {b}")
            if owner in owners:
                raise ValueError(f"owner {owner} already holds block {b}")
        for b in ids:
            self._owners[b].add(owner)

    def free(self, ids: Sequence[int], owner: int) -> None:
        """Drop ``owner``'s ref on each block; a block returns to the pool
        exactly when its last ref drops.  Owner-checked (a double free or
        a foreign free raises instead of corrupting the list)."""
        for b in ids:
            owners = self._owners.get(b)
            if owners is None or owner not in owners:
                raise ValueError(
                    f"block {b} not owned by {owner} "
                    f"(owners: {sorted(owners) if owners else None})")
            owners.discard(owner)
            if not owners:
                del self._owners[b]
                self._free.append(b)

    def refcount(self, b: int) -> int:
        return len(self._owners.get(b, ()))

    def owners(self, b: int) -> Tuple[int, ...]:
        return tuple(sorted(self._owners.get(b, ())))

    def owned(self, owner: int) -> List[int]:
        return sorted(b for b, o in self._owners.items() if owner in o)

    def check_conservation(self) -> None:
        """Every usable block is exactly once either free or referenced
        (by ≥ 1 owner) — never both, never lost."""
        owned = set(self._owners)
        free = set(self._free)
        assert all(self._owners[b] for b in owned), \
            f"blocks with empty owner sets: {[b for b in owned if not self._owners[b]]}"
        assert not (owned & free), f"blocks both free and owned: {owned & free}"
        assert owned | free == set(range(1, self.n_blocks)), \
            f"lost blocks: {set(range(1, self.n_blocks)) - owned - free}"


# ==========================================================================
# Content-addressed prefix index (radix trie over full token blocks)
# ==========================================================================

class _TrieNode:
    __slots__ = ("key", "block", "chain_hash", "children", "parent", "lru")

    def __init__(self, key, block, chain_hash, parent):
        self.key = key                    # tuple of block_size token ids
        self.block = block                # pool block id holding the KV
        self.chain_hash = chain_hash      # H(parent_hash, key, salt)
        self.children: Dict[tuple, "_TrieNode"] = {}
        self.parent = parent
        self.lru = 0


class PrefixCache:
    """Radix trie over *full* KV blocks, keyed by the block's token ids
    chained from the root — so a node's identity is its whole token
    prefix, and its ``chain_hash`` is the content address
    ``H(parent_hash, tokens, salt)``.  The trie holds one allocator ref
    (owner :data:`OWNER`) per indexed block, which keeps finished
    requests' prefixes alive for later arrivals until LRU eviction
    reclaims them under pool pressure.
    """

    OWNER = -1                            # the cache's allocator owner id

    def __init__(self, allocator: BlockAllocator, block_size: int,
                 salt: tuple = ()):
        self.allocator = allocator
        self.block_size = block_size
        self.salt = tuple(salt)
        self.root = _TrieNode((), 0, hash(("prefix-root", self.salt)), None)
        self._clock = 0
        self.stats = dict(lookups=0, hit_tokens=0, hit_blocks=0,
                          partial_hits=0, inserted=0, deduped=0, evicted=0)

    # ------------------------------------------------------------ internal
    def _touch(self, node: _TrieNode) -> None:
        self._clock += 1
        node.lru = self._clock

    @property
    def n_blocks(self) -> int:
        """Blocks currently indexed (== allocator refs held by OWNER)."""
        return len(self.allocator.owned(self.OWNER))

    # -------------------------------------------------------------- lookup
    def lookup(self, tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """Longest cached prefix of ``tokens``: returns ``(n_hit,
        block_ids)`` where the first ``n_hit`` tokens' KV lives in
        ``block_ids`` (in table order).  The last returned block may be a
        *partial tail* match — a cached full block whose first ``j``
        tokens extend the prefix (``n_hit`` counts only those ``j``); the
        caller must copy-on-write before writing positions ≥ ``n_hit``
        into it."""
        bs = self.block_size
        tokens = [int(t) for t in tokens]
        self.stats["lookups"] += 1
        node, i, ids = self.root, 0, []
        while i + bs <= len(tokens):
            child = node.children.get(tuple(tokens[i:i + bs]))
            if child is None:
                break
            ids.append(child.block)
            self._touch(child)
            node, i = child, i + bs
        rem = tuple(tokens[i:])
        if rem:                            # partial tail inside one block
            best, best_len = None, 0
            for key, child in sorted(node.children.items()):
                m = 0
                while m < len(rem) and key[m] == rem[m]:
                    m += 1
                if m > best_len:
                    best, best_len = child, m
            if best is not None:
                ids.append(best.block)
                self._touch(best)
                i += best_len
                self.stats["partial_hits"] += 1
        self.stats["hit_tokens"] += i
        self.stats["hit_blocks"] += len(ids)
        return i, ids

    # ------------------------------------------------------------ register
    def register(self, tokens: Sequence[int],
                 blocks: Sequence[int]) -> List[Tuple[int, int]]:
        """Index the full blocks of ``tokens`` (``len(blocks)`` ==
        ``len(tokens) // block_size``), whose KV lives in ``blocks``.

        For each depth, either the trie gains a node for our block (the
        cache takes a ref), or an *equal* block is already indexed — then
        ``(depth, canonical_block)`` is returned so the caller can
        dedupe-swap its table entry onto the canonical copy.  A zero
        (reclaimed) entry ends the walk: its content is gone.
        """
        bs = self.block_size
        tokens = [int(t) for t in tokens]
        node, swaps = self.root, []
        for d, b in enumerate(blocks):
            key = tuple(tokens[d * bs:(d + 1) * bs])
            child = node.children.get(key)
            if child is not None:
                if b != 0 and b != child.block:
                    swaps.append((d, child.block))
                node = child
                continue
            if b == 0:                     # reclaimed: no content to index
                break
            self.allocator.share([b], self.OWNER)
            child = _TrieNode(key, b, hash((node.chain_hash, key,
                                            self.salt)), node)
            node.children[key] = child
            self._touch(child)
            self.stats["inserted"] += 1
            node = child
        self.stats["deduped"] += len(swaps)
        return swaps

    # -------------------------------------------------------------- evict
    def evict(self, n: int) -> int:
        """Drop up to ``n`` LRU *leaf* blocks whose only referent is the
        cache itself (blocks shared with live requests are pinned).
        Returns how many were freed to the pool."""
        freed = 0
        while freed < n:
            victim = None
            for node in self._iter_leaves():
                if self.allocator.refcount(node.block) != 1:
                    continue               # shared with a live request
                if victim is None or node.lru < victim.lru:
                    victim = node
            if victim is None:
                break
            self.allocator.free([victim.block], self.OWNER)
            del victim.parent.children[victim.key]
            self.stats["evicted"] += 1
            freed += 1
        return freed

    def _iter_leaves(self):
        stack = [self.root]
        while stack:
            node = stack.pop()
            if node is not self.root and not node.children:
                yield node
            stack.extend(node.children.values())

    def check_integrity(self) -> None:
        """Every indexed block holds exactly one cache ref; the trie is
        acyclic with consistent parent links (test aid)."""
        seen = set()
        stack = [self.root]
        while stack:
            node = stack.pop()
            for key, child in node.children.items():
                assert child.parent is node and child.key == key
                assert child.block not in seen, "block indexed twice"
                seen.add(child.block)
                assert self.OWNER in self.allocator.owners(child.block)
                stack.append(child)
        assert seen == set(self.allocator.owned(self.OWNER)), \
            "trie blocks and cache-owned allocator refs diverge"


@dataclasses.dataclass
class PagedKVCache:
    """Device block pools + per-slot block tables + the allocator."""
    cfg: ModelConfig
    block_size: int
    n_blocks: int                    # incl. the reserved null block 0
    max_reqs: int                    # batch slots == block-table rows
    max_blocks_per_req: int
    pools: Dict[str, torch.Tensor]
    allocator: BlockAllocator
    table: np.ndarray                # (max_reqs, max_blocks_per_req) int32
    n_assigned: np.ndarray           # (max_reqs,) blocks assigned per slot
    prefix: Optional[PrefixCache] = None
    sharding: Optional[str] = None   # "heads" | "blocks" | None (whole)
    group: Optional[object] = None   # the Comm of the sharded mesh axis
    counters: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict(forks=0, reclaimed=0, hit_tokens=0,
                                     hit_blocks=0, evicted=0, dedup_swaps=0))

    # ------------------------------------------------------------ creation
    @classmethod
    def create(cls, cfg: ModelConfig, *, block_size: Optional[int] = None,
               n_blocks: int = 64, max_reqs: int = 8,
               max_blocks_per_req: Optional[int] = None,
               prefix_cache: bool = False, device="cuda",
               dtype: Optional[torch.dtype] = None, mesh=None,
               seq_axis: str = "model") -> "PagedKVCache":
        """A cache of ``n_blocks`` blocks (block 0 the null block).  With
        ``mesh`` the pools shard over ``seq_axis`` (module docstring) and
        this rank allocates its part."""
        a = cfg.attn
        if a is None:
            raise ValueError(f"the paged KV cache serves attention layers "
                             f"(arch {cfg.arch_type!r} has none)")
        if block_size is None:
            block_size = cls.default_block_size(a, mesh, seq_axis)
        if max_blocks_per_req is None:
            max_blocks_per_req = n_blocks - 1
        if dtype is None:
            dtype = {"float32": torch.float32,
                     "bfloat16": torch.bfloat16}[cfg.dtype]
        s = (cfg.n_layers, n_blocks, block_size, a.n_kv_heads, a.head_dim)
        names = ("k_pool", "v_pool")
        if a.is_mla:
            s = (cfg.n_layers, n_blocks, block_size,
                 a.kv_lora_rank + a.qk_rope_head_dim)
            names = ("ckv_pool",)
        sharding, group = None, None
        if mesh is not None and mesh.size(seq_axis) > 1:
            group = mesh.comms[seq_axis]
            sharding = cls._pool_sharding(s, group.size)
            if sharding == "heads":
                s = s[:3] + (s[3] // group.size,) + s[4:]
            elif sharding == "blocks":
                s = s[:1] + (s[1] // group.size,) + s[2:]
            else:
                group = None
        pools = {k: torch.zeros(s, dtype=dtype, device=device)
                 for k in names}
        allocator = BlockAllocator(n_blocks)
        prefix = None
        if prefix_cache:
            # the salt is the MaskSpec-relevant config: a block's content
            # address must distinguish caches whose KV would differ for
            # the same token ids
            salt = (cfg.name, block_size, int(a.window or 0))
            prefix = PrefixCache(allocator, block_size, salt)
        return cls(cfg=cfg, block_size=block_size, n_blocks=n_blocks,
                   max_reqs=max_reqs, max_blocks_per_req=max_blocks_per_req,
                   pools=pools, allocator=allocator,
                   table=np.zeros((max_reqs, max_blocks_per_req), np.int32),
                   n_assigned=np.zeros((max_reqs,), np.int32),
                   prefix=prefix, sharding=sharding, group=group)

    @staticmethod
    def default_block_size(a=None, mesh=None, seq_axis: str = "model") -> int:
        """The pool granularity when the caller passes none: the
        ``REPRO_TUNE_BLOCK_SIZE`` variable, else the active tuning table's
        winner for this kv layout (``a``, the attention config: a latent
        pool is ``"mla"``) and pool sharding (``"pool"`` when ``mesh``'s
        ``seq_axis`` has more than one rank), else 16 (``repro_torch.
        tune``; no table ships with the port yet)."""
        from repro_torch.tune import table as tt
        bs = tt.env_int("REPRO_TUNE_BLOCK_SIZE")
        if bs is not None:
            return bs
        tab = tt.active_table()
        if tab is not None:
            size = 1 if mesh is None else mesh.size(seq_axis)
            hit = tab.best_block_size(
                layout="mla" if a is not None and a.is_mla else "mha",
                sharding="none" if size <= 1 else "pool")
            if hit is not None:
                return hit
        return 16

    @staticmethod
    def _pool_sharding(shape: Tuple[int, ...], size: int) -> Optional[str]:
        """Head-parallel when a k / v pool's kv-head axis (``shape`` (L, N,
        bs, Hkv, D)) divides the axis size, else pool-block-sharded, else
        replicated (None).  A latent pool (L, N, bs, kv_lora + rope) has no
        head axis: blocks or nothing."""
        if size <= 1:
            return None
        if len(shape) == 5 and shape[3] % size == 0:
            return "heads"
        if shape[1] % size == 0:
            return "blocks"
        return None

    # ------------------------------------------------------------- queries
    @property
    def shard(self) -> Optional[PoolShard]:
        """This rank's part of a sharded pool, or None (whole pool)."""
        if self.sharding is None:
            return None
        dim = 3 if self.sharding == "heads" else 1
        return PoolShard(self.sharding, self.group,
                         next(iter(self.pools.values())).shape[dim])

    @property
    def layout(self) -> str:
        """The kv layout: k and v pools per kv head (``"mha"``), or one
        latent pool (``"mla"``)."""
        return "mla" if self.cfg.attn.is_mla else "mha"

    def blocks_for(self, n_tokens: int) -> int:
        return max(1, math.ceil(n_tokens / self.block_size))

    def fits(self, n_tokens: int) -> bool:
        """Could a request of this total length *ever* run (alone)?"""
        n = self.blocks_for(n_tokens)
        return n <= min(self.allocator.n_usable, self.max_blocks_per_req)

    def needs_block(self, slot: int, write_pos: int) -> bool:
        """Writing a token at context position ``write_pos`` needs a block
        that slot doesn't own yet?"""
        return write_pos // self.block_size >= int(self.n_assigned[slot])

    @property
    def n_cache_blocks(self) -> int:
        """Blocks pinned by the prefix cache only (0 when disabled)."""
        return self.prefix.n_blocks if self.prefix is not None else 0

    # ---------------------------------------------------------- alloc/free
    def _alloc(self, rid: int, n: int) -> List[int]:
        """Allocate with prefix-cache eviction as the fallback: cache-only
        blocks are LRU-evicted to make room before PoolExhausted
        propagates (and triggers scheduler preemption)."""
        while True:
            try:
                return self.allocator.alloc(rid, n)
            except PoolExhausted:
                if self.prefix is None:
                    raise
                short = n - self.allocator.n_free
                evicted = self.prefix.evict(short)
                self.counters["evicted"] += evicted
                if evicted < short:
                    raise

    def assign(self, slot: int, rid: int, n_tokens: int,
               tokens: Optional[Sequence[int]] = None) -> int:
        """Table the blocks for a fresh ``n_tokens`` context (admission).
        When ``tokens`` (the prefill token ids) are given and the prefix
        cache is enabled, cached prefix blocks are *shared* instead of
        allocated; returns the number of prefix tokens whose KV is already
        cached (0 without a hit).  Atomic w.r.t. PoolExhausted."""
        n = self.blocks_for(n_tokens)
        if n > self.max_blocks_per_req:
            raise ValueError(f"request needs {n} blocks > "
                             f"max_blocks_per_req={self.max_blocks_per_req}")
        assert int(self.n_assigned[slot]) == 0, f"slot {slot} not empty"
        n_hit, hit_ids = 0, []
        if self.prefix is not None and tokens is not None:
            n_hit, hit_ids = self.prefix.lookup(tokens)
        # ref the hits FIRST so the eviction fallback can never free them,
        # then allocate; roll the refs back on exhaustion (atomicity)
        self.allocator.share(hit_ids, rid)
        try:
            fresh = self._alloc(rid, n - len(hit_ids))
        except PoolExhausted:
            self.allocator.free(hit_ids, rid)
            raise
        self.table[slot, :n] = hit_ids + fresh
        self.n_assigned[slot] = n
        self.counters["hit_tokens"] += n_hit
        self.counters["hit_blocks"] += len(hit_ids)
        return n_hit

    def extend(self, slot: int, rid: int) -> int:
        """Append one block to a slot's table (decode growth)."""
        n = int(self.n_assigned[slot])
        if n >= self.max_blocks_per_req:
            raise ValueError(f"slot {slot} at max_blocks_per_req")
        (b,) = self._alloc(rid, 1)
        self.table[slot, n] = b
        self.n_assigned[slot] = n + 1
        return b

    def release(self, slot: int, rid: int) -> None:
        """Drop a slot's refs (finish or preemption) and null its row.
        Zero table entries (window-reclaimed blocks) are already free;
        shared blocks survive under their other owners."""
        n = int(self.n_assigned[slot])
        ids = [int(b) for b in self.table[slot, :n] if b != 0]
        self.allocator.free(ids, rid)
        self.table[slot, :] = 0
        self.n_assigned[slot] = 0

    # ------------------------------------------------- copy-on-write fork
    def ensure_writable(self, slot: int, rid: int, p0: int, p1: int) -> int:
        """Before writing context positions ``[p0, p1)``: fork a private
        copy of every covered block that is shared (refcount > 1), so the
        write never mutates another owner's (or the cache's) KV.  Returns
        the number of blocks forked."""
        if p1 <= p0:
            return 0
        bs = self.block_size
        forks = 0
        for i in range(p0 // bs, (p1 - 1) // bs + 1):
            b = int(self.table[slot, i])
            assert b != 0 and i < int(self.n_assigned[slot]), \
                f"write into unassigned/reclaimed block {i} of slot {slot}"
            if self.allocator.refcount(b) == 1:
                continue
            (nb,) = self._alloc(rid, 1)
            self._copy_block(b, nb)
            self.table[slot, i] = nb
            self.allocator.free([b], rid)
            forks += 1
        self.counters["forks"] += forks
        return forks

    # ------------------------------------------------- windowed reclamation
    def reclaim_window(self, slot: int, rid: int, next_pos: int,
                       window: int) -> int:
        """Drop the slot's refs on blocks wholly below the sliding window
        of the next write position (every kv position the request can
        still attend is ≥ ``next_pos + 1 - window``).  Table entries are
        zeroed — the paged kernels' window masking never reads them — and
        ``n_assigned`` stays a high-water mark so decode growth is
        unaffected.  Returns how many refs were dropped."""
        if not window:
            return 0
        bs = self.block_size
        floor_pos = next_pos + 1 - window
        hi = min(floor_pos // bs, int(self.n_assigned[slot]))
        freed = 0
        for i in range(hi):
            b = int(self.table[slot, i])
            if b == 0:
                continue
            self.allocator.free([b], rid)
            self.table[slot, i] = 0
            freed += 1
        self.counters["reclaimed"] += freed
        return freed

    def _copy_block(self, src: int, dst: int) -> None:
        """Block ``dst`` := block ``src`` in every layer pool.  On a
        block-sharded pool the owner of ``dst`` writes; when ``src`` lives
        on another rank its owner broadcasts it over the group first (every
        rank takes part: they run the same forks in the same order)."""
        sh = self.shard
        if sh is None or sh.kind != "blocks":
            for pool in self.pools.values():
                pool[:, dst] = pool[:, src]
            return
        (s_rank, s_loc), (d_rank, d_loc) = (divmod(b, sh.n_local)
                                            for b in (src, dst))
        me = sh.group.rank
        for pool in self.pools.values():
            if s_rank == d_rank:
                if me == s_rank:
                    pool[:, d_loc] = pool[:, s_loc]
                continue
            buf = (pool[:, s_loc].contiguous() if me == s_rank
                   else pool.new_empty(pool[:, 0].shape))
            sh.group.broadcast_([buf], s_rank)
            if me == d_rank:
                pool[:, d_loc] = buf

    def _fill_block(self, b: int, value: float) -> None:
        """Block ``b`` := ``value`` in every layer pool, on the rank that
        holds it (every rank when the pool is not block-sharded)."""
        for i in self._blocks_here([b])[1].tolist():
            for pool in self.pools.values():
                pool[:, i] = value

    # --------------------------------------------------- prefix indexing
    def register_prefix(self, slot: int, rid: int, tokens: Sequence[int],
                        upto: int) -> None:
        """Index the slot's *full* blocks covering ``tokens[:upto]``
        (positions whose KV has been written) into the prefix cache; on a
        content-equal duplicate, swap our table entry onto the canonical
        block and drop the duplicate ref (dedupe)."""
        if self.prefix is None:
            return
        nfull = min(upto // self.block_size, int(self.n_assigned[slot]))
        if nfull <= 0:
            return
        blocks = [int(b) for b in self.table[slot, :nfull]]
        for d, canonical in self.prefix.register(tokens[:nfull *
                                                        self.block_size],
                                                 blocks):
            ours = int(self.table[slot, d])
            self.allocator.share([canonical], rid)
            self.allocator.free([ours], rid)
            self.table[slot, d] = canonical
            self.counters["dedup_swaps"] += 1

    # ------------------------------------------------- fault / audit hooks
    def corrupt_block(self, b: int) -> None:
        """Fill block ``b`` with NaN in every layer pool (fault injection:
        the request that attends it sees NaN logits and is quarantined)."""
        self._fill_block(b, float("nan"))

    def scrub_slot(self, slot: int, rid: int) -> int:
        """Zero every block of ``slot`` that ``rid`` owns exclusively —
        quarantine hygiene: poisoned content must never survive into the
        free list (shared blocks are other owners' clean data and are left
        alone).  Returns the number of blocks scrubbed."""
        n = int(self.n_assigned[slot])
        scrubbed = 0
        for i in range(n):
            b = int(self.table[slot, i])
            if b and self.allocator.owners(b) == (rid,):
                self._fill_block(b, 0.0)
                scrubbed += 1
        return scrubbed

    def audit(self, running: Optional[Dict[int, object]] = None) -> None:
        """Run the allocator / prefix-trie / block-table invariants and
        raise a structured :class:`AuditFailure` naming the first violated
        one.  ``running`` is the scheduler's slot→request map; when given,
        table ownership is cross-checked against it."""
        try:
            self.allocator.check_conservation()
        except AssertionError as e:
            raise AuditFailure("allocator_conservation", str(e)) from e
        if self.prefix is not None:
            try:
                self.prefix.check_integrity()
            except AssertionError as e:
                raise AuditFailure("prefix_trie", str(e)) from e
        if running is None:
            return
        for slot in range(self.max_reqs):
            n = int(self.n_assigned[slot])
            req = running.get(slot)
            if req is None:
                if n:
                    raise AuditFailure(
                        "table_ownership",
                        f"idle slot {slot} still holds {n} blocks")
                continue
            for i in range(n):
                b = int(self.table[slot, i])
                if b and req.rid not in self.allocator.owners(b):
                    raise AuditFailure(
                        "table_ownership",
                        f"slot {slot} tables block {b} not owned by "
                        f"rid {req.rid} (owners {self.allocator.owners(b)})")
            if np.any(self.table[slot, n:]):
                raise AuditFailure(
                    "table_ownership",
                    f"slot {slot} has table entries beyond "
                    f"n_assigned={n}")

    # ------------------------------------------------------------- page io
    def _blocks_here(self, ids):
        """(positions in ``ids`` of the blocks this rank holds, their
        local ids) — every block, unless the pool is block-sharded."""
        ids = torch.as_tensor(ids, dtype=torch.long)
        if self.sharding != "blocks":
            return torch.arange(len(ids)), ids
        n_loc = self.n_blocks // self.group.size
        lo = self.group.rank * n_loc
        keep = ((ids >= lo) & (ids < lo + n_loc)).nonzero()[:, 0]
        return keep, ids[keep] - lo

    def page_in(self, slot: int, dense_cache: Dict[str, torch.Tensor],
                n_tokens: int) -> None:
        """Scatter a prefill's dense cache ``{"k", "v"}`` (L, 1, T, Hkv, D)
        (leading layer dim, B = 1, every kv head), or ``{"ckv"}`` (L, 1, T,
        kv_lora + rope) into a latent pool, into the slot's blocks; only
        the first ``n_tokens`` positions page in (T may be padded).  A
        sharded pool takes this rank's heads or blocks."""
        n = self.blocks_for(n_tokens)
        assert n <= int(self.n_assigned[slot])
        bs = self.block_size
        at, ids = self._blocks_here(self.table[slot, :n])
        for dk in ("k", "v", "ckv"):
            if dk + "_pool" not in self.pools:
                continue
            pool = self.pools[dk + "_pool"]
            x = dense_cache[dk][:, 0]                  # (L, T, Hkv, D)
            L, T = x.shape[0], x.shape[1]
            if self.sharding == "heads":
                h = pool.shape[3]
                x = x[:, :, self.group.rank * h:(self.group.rank + 1) * h]
            x = x[:, :n * bs]
            pad = n * bs - x.shape[1]
            if pad:
                x = torch.cat([x, x.new_zeros((L, pad) + x.shape[2:])], 1)
            blocks = x.reshape(L, n, bs, *x.shape[2:])
            pool[:, ids.to(pool.device)] = blocks[:, at.to(x.device)].to(
                device=pool.device, dtype=pool.dtype)

    def gather(self, slot: int, length: int) -> Dict[str, torch.Tensor]:
        """Contiguous (L, length, Hkv, D) view of a slot's cache, every kv
        head (a latent pool: ``{"ckv"}`` (L, length, kv_lora + rope)) — a
        test / debugging aid (decode never materializes it); a
        sharded pool is all-gathered over its ranks first."""
        n = self.blocks_for(length)
        ids = torch.as_tensor(self.table[slot, :n], dtype=torch.long)
        out = {}
        for pk, pool in self.pools.items():
            if self.sharding == "blocks":
                pool = self.group.all_gather(pool, dim=1)
            p = pool[:, ids.to(pool.device)]           # (L, n, bs, ...)
            p = p.reshape(p.shape[0], -1, *p.shape[3:])[:, :length]
            if self.sharding == "heads":
                p = self.group.all_gather(p.contiguous(), dim=2)
            out[pk[:-5]] = p
        return out


def gather_pool(pool, shard: Optional[PoolShard]):
    """One layer's whole pool (N, bs, ...) on every rank: a block-sharded
    pool's blocks all-gathered from their owners in rank order (what GSPMD
    does for the reference); any other pool as it is."""
    if shard is None or shard.kind != "blocks":
        return pool
    return shard.group.all_gather(pool, dim=0)


def sharded_paged_attn(q, kp, vp, block_table, lengths,
                       shard: Optional[PoolShard], **kw):
    """Paged decode of q (B, T, Hq, D), the same on every rank, over one
    layer's pools ``kp`` / ``vp`` holding this rank's part ``shard`` of a
    pool (None: the whole pool); returns o (B, T, Hq, D), the same on every
    rank.  ``kw`` goes to ``paged_decode_attn`` (``mask``, ``scale``,
    ``impl``).

    * ``"heads"`` — kernel B on this rank's kv heads and their query heads
      (``Hq / n`` of them), then the outputs all-gathered over heads.  B is
      per head and batch-invariant, so this equals one B over every head
      bit for bit.
    * ``"blocks"`` — the owners' blocks all-gathered to every rank
      (:func:`gather_pool`), then B on the gathered pool.
    * replicated — B on the pool.
    """
    if shard is not None and shard.kind == "heads":
        g = shard.group
        hq = q.shape[2] // g.size
        mine = q[:, :, g.rank * hq:(g.rank + 1) * hq].contiguous()
        o = paged_decode_attn(mine, kp, vp, block_table, lengths, **kw)
        return g.all_gather(o.contiguous(), dim=2)
    return paged_decode_attn(q, gather_pool(kp, shard),
                             gather_pool(vp, shard), block_table, lengths,
                             **kw)


def sharded_latent_attn(q, cp, kv_lora: int, block_table, lengths,
                        shard: Optional[PoolShard], **kw):
    """Absorbed-MLA paged attention of q (B, T, H, kv_lora + rope) over one
    layer's latent pool ``cp`` (N, bs, kv_lora + rope), this rank's part
    ``shard`` of it (a latent pool has one kv head, so it is block-sharded
    or whole): the pool gathered once (:func:`gather_pool`), then kernel B
    with its rows as the one kv head and v their first ``kv_lora`` columns
    (a view).  Returns the latent output (B, T, H, kv_lora), the same on
    every rank."""
    kv = gather_pool(cp, shard)[:, :, None, :]
    return paged_decode_attn(q, kv, kv[..., :kv_lora], block_table, lengths,
                             **kw)


def sharded_paged_decode_attn(q, cache: PagedKVCache, layer: int,
                              block_table, lengths, *, mask=None,
                              scale=None, impl=None):
    """:func:`sharded_paged_attn` (a latent pool:
    :func:`sharded_latent_attn`) over layer ``layer`` of ``cache``'s pools,
    wherever they live (``PagedKVCache.create(mesh=)``)."""
    kw = dict(mask=mask, scale=scale, impl=impl)
    if "ckv_pool" in cache.pools:
        return sharded_latent_attn(
            q, cache.pools["ckv_pool"][layer], cache.cfg.attn.kv_lora_rank,
            block_table, lengths, cache.shard, **kw)
    return sharded_paged_attn(
        q, cache.pools["k_pool"][layer], cache.pools["v_pool"][layer],
        block_table, lengths, cache.shard, **kw)

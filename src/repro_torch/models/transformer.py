"""Dense decoder LM for training and paged serving (port of the reference
``models/transformer.py``: ``DecoderLM.init``, ``loss`` with its dense layer
stages, ``prefill_chunk``, paged ``decode``, ``_head`` and the paged-write
helpers).

Training runs each layer under the checkpoint policy of
``ParallelConfig.remat`` (``remat_aware`` by default, ``core/remat.py``):
attention goes through ``core/dist_attention`` (kernel A forward, kernels C
and D backward).  On a process-group mesh (``launch/mesh.py``) each rank
holds its (data, seq) shard of tokens, labels and segment ids: its rope
tables use the shard's global positions, attention runs the
``ParallelConfig.schedule`` over the ``model`` axis, and ``loss`` is the
global token mean (sum and count all-reduced over the ranks holding
distinct tokens).  :func:`trainable` turns a parameter tree into leaf
tensors that require gradients.

The reference scans stacked layers with ``lax.scan``; here the parameters
hold a Python list of per-layer dicts and the layers run in a loop.  The
paged KV pools are torch tensors ``(L, N, bs, Hkv, D)`` that the model
updates **in place** (``index_put_``) — the reference donates them to jit
instead.  Block 0 of a pool is the reserved null block: padded chunk rows
and idle decode rows write there, and it is never read unmasked.

:func:`load_reference_params` carries the reference's ``DecoderLM.init``
pytree (nested dicts of numpy arrays, layers stacked on a leading L axis)
into this layout, and :func:`load_reference_opt_state` the reference's
``AdamWState``.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core import mask as mk
from repro_torch.core.attention import chunk_attn, paged_decode_attn
from repro_torch.core.config import ModelConfig, ParallelConfig
from repro_torch.core.dist_attention import (DistAttnSpec, dist_attn_bwd,
                                             dist_attn_fwd, dist_flash_attn,
                                             shard_positions)
from repro_torch.core.remat import apply_policy, remat_aware
from repro_torch.core.tree import tree_map
from repro_torch.models import layers as L
from repro_torch.optim.adamw import AdamWState

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def decode_mask(window) -> mk.MaskSpec:
    """The new tokens are a context suffix: whole-cache causal, or a
    sliding window."""
    return mk.sliding_window(int(window)) if window else mk.causal()


# --------------------------------------------------------------------------
# Training layer: stage functions feed the remat-aware combinator
# --------------------------------------------------------------------------

def _zigzag_ok(cfg: ModelConfig) -> bool:
    """The zigzag relayout is valid only for purely positionwise decoders
    without windowed masks (a window assumes contiguous shard
    positions)."""
    return cfg.arch_type == "dense" and not cfg.attn.window


def zigzag_layout(cfg: ModelConfig, par: ParallelConfig, P: int) -> bool:
    """Do the ranks hold the zigzag layout of the sequence (the reference
    permutes after the embedding; here the pipeline shards that way)?"""
    return par.schedule == "zigzag" and _zigzag_ok(cfg) and P > 1


def _attn_spec(cfg: ModelConfig, par: ParallelConfig, P: int, impl,
               document: bool) -> DistAttnSpec:
    """The reference's ``_attn_spec`` for a causal decoder (no 2D mesh)."""
    w = int(cfg.attn.window or 0)
    sched = par.schedule
    if sched == "zigzag" and not _zigzag_ok(cfg):
        sched = "balanced"
    if sched != "auto" and w and sched not in ("balanced", "ring",
                                               "ulysses"):
        sched = "balanced"                   # windowed plans truncate
    mask = mk.MaskSpec(causal=True, window=w, document=document)
    return DistAttnSpec(axis=par.seq_axis, axis_size=P, schedule=sched,
                        mask=mask, impl=impl)


def _dense_stages(cfg: ModelConfig, spec: DistAttnSpec, group):
    """Stages over x = (h, cos, sin, seg): ``seg`` holds the packed
    batch's document ids, or None; ``group`` is the sequence axis's
    Comm."""
    def pre(p, x):
        h, cos, sin, seg = x
        return L.attn_qkv(p["attn"], h, cfg, cos, sin) + (seg,)

    def attn_fwd(qkv):
        q, k, v, seg = qkv
        return dist_attn_fwd(q, k, v, spec=spec, group=group, segments=seg)

    def attn_bwd(qkv, o, lse, do):
        q, k, v, seg = qkv
        return dist_attn_bwd(q, k, v, o, lse, do, spec=spec, group=group,
                             segments=seg)

    def attn_diff(qkv):
        q, k, v, seg = qkv
        return dist_flash_attn(q, k, v, spec, group, seg)

    return pre, attn_fwd, attn_bwd, attn_diff


def build_dense_layer(cfg: ModelConfig, par: ParallelConfig, impl=None, *,
                      document: bool = False, P: int = 1, group=None):
    """``layer(params, (h, cos, sin, seg)) -> h'`` under ``par.remat``, its
    attention over the ``P`` ranks of ``group``."""
    pre, attn_fwd, attn_bwd, attn_diff = _dense_stages(
        cfg, _attn_spec(cfg, par, P, impl, document), group)

    def post(p, x, o):
        h2 = L.attn_out(p["attn"], x[0], o, cfg)
        return L.mlp_apply(p["mlp"], h2, cfg.norm_eps)

    if par.remat == "remat_aware":
        return remat_aware(pre, attn_fwd, attn_bwd, post)

    def plain(p, x):
        o, _ = attn_diff(pre(p, x))
        return post(p, x, o)

    return apply_policy(plain, par.remat)


def token_group(mesh, par: ParallelConfig):
    """The ranks holding distinct tokens: the whole world when the batch
    shards over ``data`` (or there is no data axis), else the sequence
    axis (data replicas then hold the same batch)."""
    if mesh is None:
        return None
    if "data" in par.batch_axes or mesh.size("data") == 1:
        return mesh.world
    return mesh.comms[par.seq_axis]


def trainable(params) -> dict:
    """The parameter tree as leaf tensors that require gradients (the same
    storage, in the same dtype)."""
    return tree_map(lambda t: t.detach().requires_grad_(True), params)


class DecoderLM:
    """Dense / GQA Llama-family decoder (RMSNorm, rope, SwiGLU).

    ``par`` sets the training layout (``par.remat``, ``par.schedule``);
    ``impl`` names the attention backend (``cuda``, the default, or
    ``ref``); ``mesh`` is this rank's process-group mesh
    (``launch.mesh.make_local_mesh``), or None for one process."""

    def __init__(self, cfg: ModelConfig, device="cuda", *,
                 par: Optional[ParallelConfig] = None, impl=None,
                 mesh=None):
        if cfg.arch_type != "dense" or cfg.attn is None:
            raise ValueError(f"the port runs dense GQA decoders (got "
                             f"{cfg.arch_type!r})")
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = DTYPES[cfg.dtype]
        self.par = ParallelConfig() if par is None else par
        self.impl = impl
        self.mesh = mesh
        ax = self.par.seq_axis
        self.seq_size = 1 if mesh is None else mesh.size(ax)
        self.seq_rank = 0 if mesh is None else mesh.coord(ax)
        self.seq_group = None if mesh is None else mesh.comms[ax]
        self.token_group = token_group(mesh, self.par)

    # ------------------------------------------------------------- init
    def init(self, seed: int = 0) -> dict:
        """Random parameters made on ``self.device`` from a seeded
        generator: N(0, 1/d_in) projections, N(0, 0.02²) embeddings, unit
        norms (the reference's init scheme; its bits differ)."""
        cfg, a, dt = self.cfg, self.cfg.attn, self.dtype
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        d, hd = cfg.d_model, a.head_dim

        def normal(shape, scale):
            x = torch.randn(shape, generator=gen, device=self.device)
            return (x * scale).to(dt)

        def dense(d_in, d_out):
            return normal((d_in, d_out), 1.0 / math.sqrt(d_in))

        def ones(n):
            return torch.ones(n, dtype=dt, device=self.device)

        p = {"embed": normal((cfg.vocab, d), 0.02), "ln_f": ones(d)}
        if not cfg.tie_embeddings:
            p["head"] = dense(d, cfg.vocab)
        p["layers"] = [{
            "attn": {"wq": dense(d, a.n_heads * hd),
                     "wk": dense(d, a.n_kv_heads * hd),
                     "wv": dense(d, a.n_kv_heads * hd),
                     "wo": dense(a.n_heads * hd, d), "ln": ones(d)},
            "mlp": {"wg": dense(d, cfg.d_ff), "wu": dense(d, cfg.d_ff),
                    "wd": dense(cfg.d_ff, d), "ln": ones(d)},
        } for _ in range(cfg.n_layers)]
        return p

    # ------------------------------------------------------------- head
    def _head(self, p, h):
        h = L.rms_norm(h, p["ln_f"], self.cfg.norm_eps)
        w = p["embed"].T if self.cfg.tie_embeddings else p["head"]
        return h @ w.to(h.dtype)

    # ------------------------------------------------------------ train
    def _embed(self, p, batch):
        return L.embed(p["embed"], batch["tokens"].to(self.device),
                       self.dtype)

    def _backbone(self, p, h, cos, sin, seg=None):
        """The layers under the checkpoint policy; ``seg`` = packed-batch
        document ids (B, Tl) or None."""
        layer = build_dense_layer(self.cfg, self.par, self.impl,
                                  document=seg is not None,
                                  P=self.seq_size, group=self.seq_group)
        for lp in p["layers"]:
            h = layer(lp, (h, cos, sin, seg))
        return h

    def positions(self, Tl: int) -> torch.Tensor:
        """Global positions of this rank's Tl tokens."""
        P = self.seq_size
        pos = shard_positions(Tl * P, P, self.seq_rank,
                              zigzag_layout(self.cfg, self.par, P))
        return torch.as_tensor(pos, device=self.device)

    def loss(self, p, batch):
        """Mean next-token cross-entropy of ``batch`` = {tokens, labels
        (B, Tl); optional segment_ids (B, Tl)}, this rank's shard:
        ``(loss, {"ce": loss})``.  On a mesh the value is the global token
        mean, and its gradient is this rank's share of it (the train step
        sums gradients over :func:`token_group`)."""
        a = self.cfg.attn
        h = self._embed(p, batch)
        cos, sin = L.rope_tables(self.positions(h.shape[1]), a.head_dim,
                                 a.rope_theta)
        seg = batch.get("segment_ids")
        if seg is not None:
            seg = seg.to(self.device)
        h = self._backbone(p, h, cos, sin, seg)
        logits = self._head(p, h)
        labels = batch["labels"].to(self.device)
        if self.token_group is None or self.token_group.size == 1:
            ce = L.cross_entropy(logits, labels)
            return ce, {"ce": ce}
        s, n = L.cross_entropy_sum(logits, labels)
        tot = torch.stack([s.detach(), n])
        self.token_group.all_reduce_([tot])
        total = tot[1].clamp(min=1.0)
        mine = s / total                 # its gradient: this rank's share
        ce = tot[0] / total + (mine - mine.detach())
        return ce, {"ce": ce}

    def _layer(self, lp, h, attend, cos, sin):
        q, k, v = L.attn_qkv(lp["attn"], h, self.cfg, cos, sin)
        h = L.attn_out(lp["attn"], h, attend(q, k, v), self.cfg)
        return L.mlp_apply(lp["mlp"], h, self.cfg.norm_eps)

    # ------------------------------------------------------ plain forward
    @torch.no_grad()
    def forward(self, p, tokens, *, last_only: bool = False):
        """Whole-context forward, no cache, through the plain attention
        function (backend ``ref``) on any device: logits (B, T, V), or
        (B, 1, V) for the last position.  The oracle the paged path is held
        to."""
        a = self.cfg.attn
        tokens = torch.as_tensor(tokens, device=self.device)
        T = tokens.shape[1]
        h = L.embed(p["embed"], tokens, self.dtype)
        cos, sin = L.rope_tables(torch.arange(T, device=self.device),
                                 a.head_dim, a.rope_theta)
        spec = decode_mask(a.window)

        def attend(q, k, v):
            return chunk_attn(q, k, v, mask=spec, impl="ref")[0]

        for lp in p["layers"]:
            h = self._layer(lp, h, attend, cos, sin)
        return self._head(p, h[:, -1:] if last_only else h)

    # ---------------------------------------------------- chunked prefill
    @torch.no_grad()
    def prefill_chunk(self, p, cache, tokens, start: int, n_valid: int):
        """Chunked paged prefill of a B=1 chunk ``tokens`` (1, C) holding
        context positions ``[start, start + n_valid)``: per layer, scatter
        the chunk's K/V into the slot's pool blocks (write-then-attend),
        then attend over the context gathered through the block table
        (kernel A, with ``q_offset = start`` folded into the causal mask).
        Rows past ``n_valid`` (bucket padding) write to the null block.
        ``cache`` = {k_pool, v_pool (L, N, bs, Hkv, D), block_table (1, nkv)
        int32}; the pools are updated in place.  No logits: the last
        context token enters through decode."""
        a = self.cfg.attn
        start, end = int(start), int(start) + int(n_valid)
        bt = cache["block_table"]
        C = tokens.shape[1]
        h = L.embed(p["embed"], tokens, self.dtype)
        cos, sin = L.rope_tables(start + torch.arange(C, device=self.device),
                                 a.head_dim, a.rope_theta)
        spec = decode_mask(a.window)
        rows = bt[0].long()
        for li, lp in enumerate(p["layers"]):
            kp, vp = cache["k_pool"][li], cache["v_pool"][li]

            def attend(q, k, v, kp=kp, vp=vp):
                _paged_write_chunk(kp, k, bt, start, end)
                _paged_write_chunk(vp, v, bt, start, end)
                kg = kp[rows].reshape(1, -1, a.n_kv_heads, a.head_dim)
                vg = vp[rows].reshape(1, -1, a.n_kv_heads, a.head_dim)
                return chunk_attn(q, kg, vg, mask=spec, q_offset=start)[0]

            h = self._layer(lp, h, attend, cos, sin)

    # ------------------------------------------------------------ decode
    @torch.no_grad()
    def decode(self, p, cache, token, pos):
        """One decode step over a paged cache: ``token`` (B, 1), ``pos``
        (B,) int32 per-request context lengths (the new token's position).
        Per layer the new token's K/V is written into the request's current
        block, then kernel B attends through the block table.  Returns
        logits (B, 1, V); the pools are updated in place."""
        a = self.cfg.attn
        bt = cache["block_table"]
        h = L.embed(p["embed"], token, self.dtype)
        cos, sin = L.rope_tables(pos, a.head_dim, a.rope_theta)
        cos, sin = cos[:, None], sin[:, None]
        lengths = (pos + 1).to(torch.int32)
        spec = decode_mask(a.window)
        for li, lp in enumerate(p["layers"]):
            kp, vp = cache["k_pool"][li], cache["v_pool"][li]

            def attend(q, k, v, kp=kp, vp=vp):
                _paged_write(kp, k, bt, pos)
                _paged_write(vp, v, bt, pos)
                return paged_decode_attn(q, kp, vp, bt, lengths, mask=spec)

            h = self._layer(lp, h, attend, cos, sin)
        return self._head(p, h)


# --------------------------------------------------------------------------
# Paged-cache writes: scatter new K/V through the block table, in place
# --------------------------------------------------------------------------

def _paged_write(pool, new, block_table, pos):
    """Write ``new`` (B, 1, ...) into ``pool`` (N, bs, ...) at each
    request's slot for context position ``pos`` (B,): block
    ``block_table[b, pos_b // bs]``, offset ``pos_b % bs``.  Idle rows
    (all-zero table rows) land in the null block 0."""
    bs = pool.shape[1]
    pos = pos.long()
    bidx = block_table.long().gather(1, (pos // bs)[:, None])[:, 0]
    pool.index_put_((bidx, pos % bs), new[:, 0].to(pool.dtype))


def _paged_write_chunk(pool, new, block_table, start: int, end: int):
    """Write a B=1 chunk ``new`` (1, C, ...) into ``pool`` (N, bs, ...):
    row ``i`` holds context position ``start + i``; rows at positions
    ``>= end`` (bucket padding) go to the null block 0."""
    bs = pool.shape[1]
    C = new.shape[1]
    idx = start + torch.arange(C, device=pool.device)
    col = torch.clamp(idx // bs, 0, block_table.shape[1] - 1)
    bidx = torch.where(idx < end, block_table[0].long()[col],
                       torch.zeros_like(idx))
    pool.index_put_((bidx, idx % bs), new[0].to(pool.dtype))


# --------------------------------------------------------------------------
# Weights importer
# --------------------------------------------------------------------------

def load_reference_params(cfg: ModelConfig, tree: dict, device="cuda",
                          dtype: Optional[torch.dtype] = None) -> dict:
    """Carry the reference ``DecoderLM.init`` pytree into the port's layout.

    ``tree`` is nested dicts of numpy arrays with the layers stacked on a
    leading ``L`` axis (``tree["layers"]["attn"]["wq"]`` is (L, d, H·hd));
    returns the port's parameters (a list of per-layer dicts) on ``device``
    in ``dtype`` (default: the config's)."""
    dt = dtype if dtype is not None else DTYPES[cfg.dtype]

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(
            device=device, dtype=dt)

    p = {"embed": t(tree["embed"]), "ln_f": t(tree["ln_f"])}
    if "head" in tree:
        p["head"] = t(tree["head"])
    stacked = tree["layers"]
    n = len(stacked["attn"]["wq"])
    if n != cfg.n_layers:
        raise ValueError(f"tree has {n} layers, config {cfg.n_layers}")
    p["layers"] = [{grp: {name: t(arr[i]) for name, arr in
                          stacked[grp].items()}
                    for grp in ("attn", "mlp")} for i in range(n)]
    return p


def load_reference_opt_state(cfg: ModelConfig, state, device="cuda"
                             ) -> AdamWState:
    """Carry the reference ``AdamWState`` (``step``, and ``m``/``v`` trees
    of numpy arrays in the reference's parameter layout) into the port's
    :class:`~repro_torch.optim.adamw.AdamWState` with float32 moments."""
    step, m, v = state
    return AdamWState(
        step=int(np.asarray(step)),
        m=load_reference_params(cfg, m, device, torch.float32),
        v=load_reference_params(cfg, v, device, torch.float32))

"""Decoder LM for training and serving (port of the reference
``models/transformer.py``: ``DecoderLM.init``, ``loss`` with its dense layer
stages, ``prefill`` across sequence ranks, ``prefill_chunk``, ``decode`` over
a paged or a sequence-sharded dense cache, the speculative ``verify``,
``_head``, ``_cache_write`` and the paged-write helpers).

Four families: dense / GQA decoders (``arch_type="dense"``: every path), and
DeepSeek's MLA + MoE decoders (``arch_type="moe"``, the reference's tree:
``dense_layers`` — the first ``moe.n_dense_layers``, a SwiGLU of
``d_dense_ff`` — then ``moe_layers``, ``models/moe.py``), and the SSM
and hybrid families (below).  An MoE model
serves through the paged path — ``prefill_chunk``, ``decode`` and
``verify`` over a latent pool — and through the dense one: the
whole-prompt ``prefill`` runs MLA *materialised* (``layers.mla_qkv``, per
head q/k of nope + rope and v of ``v_head_dim``, kernel A's pair route)
and keeps each token's latent row as the dense cache ``{"ckv"}``, which
the dense-cache ``decode`` attends absorbed.  Absorbed MLA is as the
reference's
``_chunk_mla`` / ``_decode_mla_paged`` do (``_mla_parts`` / ``_mla_out``):
the query is taken into latent space (``q_eff = q_nope · W_uk``, beside the
roped ``q_pe``: ``kv_lora + rope`` columns), each token's cache entry is its
latent row (normed c_kv ⊕ roped k_pe), one kv head serves every query head,
and the value is the first ``kv_lora`` columns of the same row; the latent
output is up-projected by ``W_uv``.  The MoE FFN takes the padded chunk's
rows through the capacity dispatch (``moe_apply``) and the decode / verify
rows through every expert (``moe_decode_apply``); the whole-prompt
prefill dispatches all of its B·T rows at once.  :meth:`forward` runs MLA
materialised.  An MoE model trains with MLA materialised (q/k of nope +
rope, v of ``v_head_dim``: kernel A's pair route forward, kernels C and D's
backward), every layer returning ``(h, aux)`` — the MoE layers' capacity
dispatch with its load-balance loss, the dense layers an aux of 0 — and
``loss = ce + aux``.
A config with ``mtp_depth`` (deepseek-v3-671b) adds DeepSeek-V3's
multi-token prediction block (``p["mtp"]``, :meth:`DecoderLM._mtp_loss`):
``loss = ce + aux + 0.3 · mtp_ce``, and zigzag falls back to balanced;
serving loads the block and leaves it unused, as the reference does.

Expert parallelism: on a mesh whose sequence axis has S > 1 ranks, each
rank holds rows ``[r·E/S, (r+1)·E/S)`` of every MoE layer's ``wg`` /
``wu`` / ``wd`` (:attr:`DecoderLM.expert_group`) and every other leaf
whole; ``moe_apply`` dispatches over the sequence group and
``moe_decode_apply`` sums its local experts over it, so training, the
whole-prompt prefill and the dense-cache decode (``FixedSlotEngine``) run
across ranks.  The paged ``Engine`` runs across them too, the model
batch-replicated over a latent pool sharded by blocks: a chunk's rows are
the same on every rank, so its MoE splits them into S contiguous blocks,
one a rank (capacity from C/S rows), and all-gathers the outputs, as the
reference's ``shard_map`` over ``P(b, seq_axis, None)`` does
(:meth:`DecoderLM._split_moe`); the chunk and the decode / verify steps
read the pool all-gathered from the blocks' owners.  With
``latent_ring=True`` (the reference's ``Runtime.latent_ring``) the
whole-prompt prefill under zigzag ships each chunk's latent rows on the
ring instead of its K/V (``dist_attn_fwd_latent``), every rank expanding
what arrives (``layers.mla_expand``).

The SSM and hybrid families (``arch_type="ssm"``, mamba2-2.7b; ``"hybrid"``,
zamba2-2.7b) stack Mamba2 mixers (``models/ssm.py``): each rank scans its
contiguous shard and the ranks relay the recurrent state and the conv halo
(zigzag falls back to balanced); a hybrid adds one shared attention block,
a dense layer 2·d_model wide on concat(h, the embedding output), after
every ``hybrid_period`` mixers (:meth:`DecoderLM._ssm_trunk`).  They train
(``loss``), ``prefill`` without a cache, and ``decode`` recurrently from
``data.pipeline.empty_decode_cache``.  On a 2D (seq, head) mesh the relay
and the halo run over all r·u ranks of the pair in sequence order — each
rank scans its own T/(r·u) rows, so no rank repeats another's and every
SSM gradient is one rank's share, summed once by the train step — while
the shared block's attention runs the 2D plan (the reference relays over
``seq`` alone, each head rank repeating its seq shard's T/r rows: the same
function of the sequence).

The vision-language family (``arch_type="vlm"``, internvl2-2b) is a dense
decoder whose sequence is ``n_image_tokens`` stub patch embeddings
(``batch["image_embeds"]``) followed by the text: rope, the shards and
zigzag's permutation run over the whole concatenated sequence, and the
image positions carry no loss.  A rank's image rows are always a prefix
of its columns (the image is the sequence's prefix, and a zigzag rank's
first chunk comes before its second), so :meth:`DecoderLM._embed` builds
them by one concatenation, as the reference does.

:class:`EncDecLM` is the Whisper-style encoder–decoder (``arch_type=
"audio"``, whisper-tiny): a non-causal encoder over ``batch["frames"]``,
run whole on every rank, and a decoder whose self-attention runs the
distributed plan and whose cross-attention attends the encoder output
locally.

Training runs each layer under the checkpoint policy of
``ParallelConfig.remat`` (``remat_aware`` by default, ``core/remat.py``):
attention goes through ``core/dist_attention`` (kernel A forward, kernels C
and D backward).  On a process-group mesh (``launch/mesh.py``) each rank
holds its (data, seq) shard of tokens, labels and segment ids: its rope
tables use the shard's global positions, attention runs the
``ParallelConfig.schedule`` over the ``model`` axis, and ``loss`` is the
global token mean (sum and count all-reduced over the ranks holding
distinct tokens).  On a 2D mesh (``make_seq2d_mesh``) the sequence shards
over the (seq, head) pair and attention runs the 2D plan (head scatter,
the schedule over ``seq``); the whole-prompt ``prefill`` and the dense
``decode`` run over the pair too.  There an MoE model's routed experts
shard over ``seq`` alone and each head rank gathers its seq shard's MoE
rows over ``head`` (``models/moe.py``, :attr:`DecoderLM.moe_rows`), as
the reference's ``shard_map`` over ``P(b, seq_axis, None)`` does; MLA
runs materialised through the 2D plan.  Zigzag at u > 1 raises (fault
3.6), and so does the latent ring there (fault 3.7).  :func:`trainable` turns a parameter tree into leaf
tensors that require gradients.

FSDP (``DecoderLM(..., fsdp=True)``; ``parallel/fsdp.py``): each rank
holds its shard of every leaf the reference's ``param_spec`` shards over
``pod`` × ``data``, and AdamW moments shaped like those shards.  Every
place a training path reads weights gathers them on use — a layer inside
its checkpoint policy (``core/remat.py``: the whole weights live only
while the layer runs forward or its backward recomputes), the embedding
and head, a hybrid's shared block, the MTP block, the encoder and the
decoder layers of :class:`EncDecLM` — and the gradients reach the shards
reduce-scattered over the FSDP axes.  :meth:`DecoderLM.init`, the
importer and the exporter work on shards; serving takes whole weights
(``parallel.fsdp.full_tree``).

Long-context serving: :meth:`DecoderLM.prefill` runs the whole prompt on
this rank's shard of the sequence and returns its dense cache shard;
:meth:`DecoderLM.pad_cache` lays it out as the reference's padded global
cache sharded over ``par.seq_axes``; :meth:`DecoderLM.decode` on that cache
runs ``dist_decode_attn`` and writes the new token into the owner shard.

The reference scans stacked layers with ``lax.scan``; here the parameters
hold a Python list of per-layer dicts and the layers run in a loop.  The
paged KV pools are torch tensors ``(L, N, bs, Hkv, D)`` that the model
updates **in place** (``index_put_``) — the reference donates them to jit
instead.  Block 0 of a pool is the reserved null block: padded chunk rows
and idle decode rows write there, and it is never read unmasked.

:func:`load_reference_params` carries the reference's ``DecoderLM.init``
pytree (nested dicts of numpy arrays, layers stacked on a leading L axis)
into this layout, and :func:`load_reference_opt_state` the reference's
``AdamWState``; :func:`to_reference_params` is the way back (the tree the
trainer checkpoints).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import mask as mk
from repro_torch.core.attention import (chunk_attn, chunk_attn_bwd,
                                        paged_decode_attn)
from repro_torch.core.config import ModelConfig, ParallelConfig
from repro_torch.core.dist_attention import (FAULT_37, DistAttnSpec,
                                             Mesh2DSpec, dist_attn_bwd,
                                             dist_attn_fwd,
                                             dist_attn_fwd_latent,
                                             dist_decode_attn,
                                             dist_flash_attn,
                                             shard_positions)
from repro_torch.core.remat import apply_policy, remat_aware
from repro_torch.core.tree import leaves, tree_map
from repro_torch.kernels.flash_attention import FlashAttnFn
from repro_torch.models import layers as L
from repro_torch.models.moe import (local_experts, moe_apply,
                                    moe_decode_apply)
from repro_torch.models.ssm import ssm_apply, ssm_decode_step, ssm_params
from repro_torch.optim.adamw import AdamWState
from repro_torch.parallel.comm import shift as comm_shift
from repro_torch.parallel.fsdp import FSDP
from repro_torch.parallel.sharding import (LAYER_KEYS, ONCE_KEYS,
                                           batch_group, comm_over,
                                           fsdp_layout, seq_group)
from repro_torch.serve.cache import (gather_pool, sharded_latent_attn,
                                     sharded_paged_attn)

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
    (dense, VLM and MoE) without MTP (its t + 2 shift crosses positions)
    and without windowed masks (a window assumes contiguous shard
    positions)."""
    return (cfg.arch_type in ("dense", "vlm", "moe")
            and not cfg.mtp_depth
            and not cfg.attn.window)


def zigzag_layout(cfg: ModelConfig, par: ParallelConfig, P: int) -> bool:
    """Do the ranks hold the zigzag layout of the sequence (the reference
    permutes after the embedding; here the pipeline shards that way)?"""
    return par.schedule == "zigzag" and _zigzag_ok(cfg) and P > 1


def _attn_spec(cfg: ModelConfig, par: ParallelConfig, P: int, impl,
               document: bool, scale=None, group=None) -> DistAttnSpec:
    """The reference's ``_attn_spec`` for a causal decoder over P ranks;
    ``group`` a 2D mesh's (seq, head) pair of Comms (P = r·u): ring-family
    plans on the seq sub-axis after the head scatter, a baseline schedule
    becoming balanced (r > 1) or ring (r == 1).  ``scale`` the softmax
    scale (None: 1/√D; MLA's ``mla_scale``)."""
    w = int(cfg.attn.window or 0)
    sched = par.schedule
    if sched == "zigzag" and not _zigzag_ok(cfg):
        sched = "balanced"
    mask = mk.MaskSpec(causal=True, window=w, document=document)
    mesh2d = None
    if isinstance(group, tuple):
        seq, head = group
        mesh2d = Mesh2DSpec(r=seq.size, u=head.size, seq_axis=par.seq_axis,
                            head_axis=par.head_axis)
        if sched not in ("auto", "ring", "balanced", "zigzag"):
            sched = "balanced" if mesh2d.r > 1 else "ring"
    elif sched != "auto" and w and sched not in ("balanced", "ring",
                                                 "ulysses"):
        sched = "balanced"                   # windowed plans truncate
    return DistAttnSpec(axis=par.seq_axis, axis_size=P, schedule=sched,
                        mask=mask, scale=scale, impl=impl, mesh2d=mesh2d)


def _dense_stages(cfg: ModelConfig, spec: DistAttnSpec, group):
    """Stages over x = (h, cos, sin, seg): ``seg`` holds the packed
    batch's document ids, or None; ``group`` is the sequence axis's
    Comm (a 2D mesh: the (seq, head) pair).  MLA runs materialised
    (``layers.mla_qkv``)."""
    qkv = L.mla_qkv if cfg.attn.is_mla else L.attn_qkv

    def pre(p, x):
        h, cos, sin, seg = x
        return qkv(p["attn"], h, cfg, cos, sin) + (seg,)

    def attn_fwd(qkv):
        # the remat-aware forward, whose backward is attn_bwd: ``auto``
        # resolves with the backward's horizon
        q, k, v, seg = qkv
        return dist_attn_fwd(q, k, v, spec=spec, group=group, segments=seg,
                             for_bwd=True)

    def attn_bwd(qkv, o, lse, do):
        q, k, v, seg = qkv
        return dist_attn_bwd(q, k, v, o, lse, do, spec=spec, group=group,
                             segments=seg)

    def attn_diff(qkv):
        q, k, v, seg = qkv
        return dist_flash_attn(q, k, v, spec, group, seg)

    return pre, attn_fwd, attn_bwd, attn_diff


def build_dense_layer(cfg: ModelConfig, par: ParallelConfig, impl=None, *,
                      document: bool = False, P: int = 1, group=None,
                      use_moe: bool = False, all_group=None, experts=None,
                      rows=None):
    """``layer(params, (h, cos, sin, seg)) -> h'`` under ``par.remat``, its
    attention over the ``P`` ranks of ``group`` (a 2D mesh: the (seq,
    head) pair of Comms).  A layer of an
    MoE-family model returns ``(h', aux)``: its MoE FFN's load-balance
    loss (``use_moe``: experts sharded over ``experts``, the loss's
    statistics over ``all_group``, a 2D mesh's rows split over ``rows``:
    ``moe_apply``'s groups), or 0 for a SwiGLU MLP."""
    scale = L.mla_scale(cfg) if cfg.attn.is_mla else None
    pre, attn_fwd, attn_bwd, attn_diff = _dense_stages(
        cfg, _attn_spec(cfg, par, P, impl, document, scale, group), group)

    def post(p, x, o):
        h2 = L.attn_out(p["attn"], x[0], o, cfg)
        if use_moe:
            return moe_apply(p["moe"], h2, cfg, group=experts,
                             all_group=all_group, rows=rows)
        h3 = L.mlp_apply(p["mlp"], h2, cfg.norm_eps)
        if cfg.moe is None:
            return h3
        return h3, torch.zeros((), dtype=torch.float32, device=h3.device)

    if par.remat == "remat_aware":
        return remat_aware(pre, attn_fwd, attn_bwd, post)

    def plain(p, x):
        o, _ = attn_diff(pre(p, x))
        return post(p, x, o)

    return apply_policy(plain, par.remat)


def _generator(device, seed):
    """The seeded generator of an init on ``device`` (None on ``meta``,
    whose tensors hold no values)."""
    if device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(int(seed))


def _randn(shape, gen, device):
    """Standard normals from ``gen``; on ``meta`` a tensor of the shape
    (the dry-run builds full-size models there)."""
    if device.type == "meta":
        return torch.empty(shape, device=device)
    return torch.randn(shape, generator=gen, device=device)


def token_axes(mesh, par: ParallelConfig) -> tuple:
    """The mesh axes whose ranks hold distinct tokens, in mesh order: the
    sequence axes (``seq_axis``, and a 2D mesh's ``head_axis``) and the
    axes the batch shards over (``data``, a multi-pod mesh's ``pod``), and
    every axis of one rank (replicas hold the same batch along the
    rest)."""
    seq = {par.seq_axis, par.head_axis}
    return tuple(a for a in mesh.axis_names
                 if a in seq or a in par.batch_axes or mesh.size(a) == 1)


def token_group(mesh, par: ParallelConfig):
    """The ranks holding distinct tokens (:func:`token_axes`): the whole
    world when the batch shards over every axis off the sequence (or they
    have one rank), the sequence axes when it shards over none of them
    (data replicas then hold the same batch)."""
    if mesh is None:
        return None
    return mesh.comm(token_axes(mesh, par))


def moe_token_group(mesh, par: ParallelConfig):
    """The ranks holding distinct MoE rows, over which the aux loss's
    statistics reduce: :func:`token_group`, less a 2D mesh's head axis
    (its ranks dispatch one seq shard's rows alike; the reference's
    ``moe_apply`` reduces over the batch axes and ``seq_axis``)."""
    if mesh is None or par.head_axis is None or \
            mesh.size(par.head_axis) == 1:
        return token_group(mesh, par)
    bg = batch_group(mesh, par)
    if bg is not None:
        return mesh.comm(tuple(a for a in mesh.axis_names
                               if a in par.batch_axes
                               or a == par.seq_axis))
    return mesh.comms[par.seq_axis]


def layer_params(p) -> list:
    """Every layer's parameters in order: ``layers``, or an MoE model's
    ``dense_layers`` then ``moe_layers``."""
    if "layers" in p:
        return p["layers"]
    return p["dense_layers"] + p["moe_layers"]


def is_expert_leaf(group, name) -> bool:
    """Is leaf ``name`` of a layer's ``group`` a routed-expert leaf
    (``moe_layers[i]["moe"]`` ``wg`` / ``wu`` / ``wd``), one of the leaves
    sharded over the sequence axis?"""
    return group == "moe" and name in ("wg", "wu", "wd")


def expert_rows(cfg: ModelConfig, t, group):
    """This rank's rows ``[r·E/S, (r+1)·E/S)`` of a routed-expert leaf
    ``t`` (E, ...), a tensor or an array, when ``group`` (S ranks) shares
    the experts (``t`` itself when ``group`` is None); a view."""
    if group is None:
        return t
    n = local_experts(cfg, group.size)
    return t[group.rank * n:(group.rank + 1) * n]


def expert_mask(params) -> list:
    """Per leaf of ``params`` (``core.tree.flatten``'s order): is it a
    routed-expert leaf (:func:`is_expert_leaf`)?"""
    def mark(tree, group=None, name=None):
        if isinstance(tree, dict):
            return {k: mark(v, name, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(mark(x, group, name) for x in tree)
        return is_expert_leaf(group, name)
    return leaves(mark(params))


def trainable(params) -> dict:
    """The parameter tree as leaf tensors that require gradients (the same
    storage, in the same dtype)."""
    return tree_map(lambda t: t.detach().requires_grad_(True), params)


class DecoderLM:
    """Llama-family decoder (RMSNorm, rope, SwiGLU): dense / GQA, VLM, MLA
    + MoE, SSM or hybrid (module docstring).

    ``par`` sets the training layout (``par.remat``, ``par.schedule``);
    ``impl`` names the attention backend (``cuda``, the default, or
    ``ref``); ``mesh`` is this rank's process-group mesh
    (``launch.mesh.make_local_mesh``), or None for one process;
    ``latent_ring`` makes an MLA model's whole-prompt prefill under the
    zigzag schedule ship latent rows on the ring (module docstring);
    ``fsdp`` shards the parameters over the mesh's FSDP axes (``pod``,
    ``data``; ``parallel/fsdp.py``): :meth:`init` then returns this rank's
    shards, :meth:`loss` takes them and gathers each weight on use, and
    the serving entry points refuse them (serve from
    ``parallel.fsdp.full_tree``'s whole tree)."""

    ARCHS = ("dense", "vlm", "moe", "ssm", "hybrid")

    def __init__(self, cfg: ModelConfig, device="cuda", *,
                 par: Optional[ParallelConfig] = None, impl=None,
                 mesh=None, latent_ring: bool = False, fsdp: bool = False):
        if cfg.arch_type not in self.ARCHS or \
                (cfg.attn is None) != (cfg.arch_type == "ssm"):
            raise ValueError(f"{type(self).__name__} runs "
                             f"{' / '.join(self.ARCHS)} models (got "
                             f"{cfg.arch_type!r}; build_model picks the "
                             f"class)")
        self.cfg = cfg
        a = cfg.attn
        # rope width, and the softmax scale (None: 1/sqrt(head dim))
        self.rope_dim = (None if a is None else a.qk_rope_head_dim
                         if a.is_mla else a.head_dim)
        self.scale = L.mla_scale(cfg) if a is not None and a.is_mla else None
        self.device = torch.device(device)
        self.dtype = DTYPES[cfg.dtype]
        self.par = ParallelConfig() if par is None else par
        self.impl = impl
        self.mesh = mesh
        self.latent_ring = bool(latent_ring)
        ax = self.par.seq_axis
        self.seq_group = seq_group(mesh, self.par)
        self.seq_size = 1 if mesh is None else self.seq_group.size
        self.seq_rank = 0 if mesh is None else self.seq_group.rank
        # the groups the attention runs over: the sequence axis, or a 2D
        # mesh's (seq, head) pair of Comms when its head axis has u > 1
        head = (None if mesh is None or self.par.head_axis is None
                else mesh.comms[self.par.head_axis])
        two_d = head is not None and head.size > 1
        self.attn_group = (mesh.comms[ax], head) if two_d \
            else self.seq_group
        # a hybrid's shared attention block: a dense layer on concat(h,
        # embedding), 2·d_model wide; zigzag falls back to balanced for the
        # SSM families (their tokens stay contiguous), the shared block's
        # attention included
        self.shared_cfg = (cfg.replace(d_model=2 * cfg.d_model,
                                       arch_type="dense", ssm=None,
                                       hybrid_period=0)
                           if cfg.arch_type == "hybrid" else None)
        self.trunk_par = (dataclasses.replace(self.par, schedule="balanced")
                          if cfg.ssm is not None and
                          self.par.schedule == "zigzag" else self.par)
        if two_d and zigzag_layout(cfg, self.par, self.seq_size):
            if latent_ring and cfg.attn.is_mla:
                raise ValueError(FAULT_37)
            raise ValueError(
                "zigzag on a 2D mesh with u > 1: the reference permutes "
                "the tokens by zigzag_perm(T, r·u) where its executor "
                "needs zigzag_perm(T, r), and its loss is off (ROADMAP "
                "fault 3.6); name balanced or ring")
        self.token_group = token_group(mesh, self.par)
        # the routed experts shard over the sequence axis — on a 2D mesh
        # over seq alone, each seq shard's experts the same on its head
        # ranks, which split its MoE rows (moe_apply's ``rows``)
        ex = None if mesh is None else mesh.comms[ax]
        self.expert_group = ex if ex is not None and ex.size > 1 else None
        self.moe_rows = head if two_d else None
        # the ranks holding distinct MoE rows: the aux statistics' group
        self.moe_token_group = moe_token_group(mesh, self.par)
        # the ranks holding the same experts and distinct rows' shares:
        # their gradients add up (a 2D mesh's head axis, and the data axis
        # when the batch shards over it)
        bg = batch_group(mesh, self.par)
        axes = (tuple(a for a in mesh.axis_names if a in self.par.batch_axes)
                if bg is not None else ()) + ((self.par.head_axis,)
                                              if two_d else ())
        self.expert_grad_group = (mesh.comm(axes) if axes and
                                  self.expert_group is not None else None)
        # the dense decode cache shards its sequence over par.seq_axes
        self.decode_group = None if mesh is None else mesh.comm(
            self.par.seq_axes)
        # a serving batch that shards over data: each replica its rows
        self.batch_group = batch_group(mesh, self.par)
        # FSDP: the layout, and the groups its leaves' gradients and norms
        # reduce over — a shard's gradient arrives summed over the FSDP
        # axes by the reduce-scatter, so the train step sums it over the
        # rest of the ranks holding distinct tokens (an expert shard's over
        # the rest of expert_grad_group); its squares sum over the FSDP
        # group (an expert shard's over the experts' axis too)
        self.fsdp = None
        self.shard_grad_group = self.shard_expert_grad_group = None
        self.expert_fsdp_group = None
        layout = fsdp_layout(self, mesh, self.par) if fsdp else None
        if layout is not None:
            fa = set(self.par.fsdp_axes)
            self.fsdp = FSDP(layout, mesh, self.par)
            self.shard_grad_group = comm_over(mesh, set(
                token_axes(mesh, self.par)) - fa)
            self.shard_expert_grad_group = comm_over(mesh, set(axes) - fa)
            if self.expert_group is not None:
                self.expert_fsdp_group = comm_over(mesh, fa | {ax})

    # ------------------------------------------------------------- init
    def init(self, seed: int = 0) -> dict:
        """Random parameters made on ``self.device`` from a seeded
        generator: N(0, 1/d_in) projections (each expert's on its own
        input width), N(0, 0.02²) embeddings, unit norms, zero q/k/v biases
        (``qkv_bias``) and unit qk-norms (``qk_norm``), a float32 MoE
        router — the reference's init scheme and tree; its bits differ.
        Each leaf is drawn in float32 and cast at once, so the largest
        float32 temporary is one leaf, never the model.  Across expert
        ranks (:attr:`expert_group`) each rank draws every leaf whole and
        keeps its rows of the routed experts: bit for bit the slice of the
        one-rank init with the same seed.  Under FSDP (``fsdp=True``) each
        subtree — a layer, the embedding, the head, a block held once — is
        drawn whole from the same generator and cut to this rank's shards
        at once, so a rank never holds more than one whole layer and its
        shards are bit for bit the slices of the replicated init."""
        cfg, a, dt = self.cfg, self.cfg.attn, self.dtype
        gen = _generator(self.device, seed)
        d = cfg.d_model
        hd = None if a is None else a.head_dim
        keep = self._keep

        def normal(shape, scale, dtype=dt):
            x = _randn(shape, gen, self.device)
            return (x * scale).to(dtype)

        def dense(d_in, d_out, n=None, dtype=dt):
            shape = (d_in, d_out) if n is None else (n, d_in, d_out)
            return normal(shape, 1.0 / math.sqrt(d_in), dtype)

        def ones(n):
            return torch.ones(n, dtype=dt, device=self.device)

        def zeros(n):
            return torch.zeros(n, dtype=dt, device=self.device)

        p = {"embed": keep(normal((cfg.vocab, d), 0.02), "embed"),
             "ln_f": ones(d)}
        if not cfg.tie_embeddings:
            p["head"] = keep(dense(d, cfg.vocab), "head")

        def mla():
            nh, qk = a.n_heads, a.qk_nope_head_dim + a.qk_rope_head_dim
            q = {"ln": ones(d)}
            if a.q_lora_rank:
                q.update(wq_a=dense(d, a.q_lora_rank),
                         q_ln=ones(a.q_lora_rank),
                         wq_b=dense(a.q_lora_rank, nh * qk))
            else:
                q["wq"] = dense(d, nh * qk)
            dv = a.v_head_dim or hd
            q.update(wkv_a=dense(d, a.kv_lora_rank + a.qk_rope_head_dim),
                     kv_ln=ones(a.kv_lora_rank),
                     wkv_b=dense(a.kv_lora_rank,
                                 nh * (a.qk_nope_head_dim + dv)),
                     wo=dense(nh * dv, d))
            return q

        def attn(d=d):
            if a.is_mla:
                return mla()
            q = {"wq": dense(d, a.n_heads * hd),
                 "wk": dense(d, a.n_kv_heads * hd),
                 "wv": dense(d, a.n_kv_heads * hd),
                 "wo": dense(a.n_heads * hd, d), "ln": ones(d)}
            if a.qkv_bias:
                q.update(bq=zeros(a.n_heads * hd),
                         bk=zeros(a.n_kv_heads * hd),
                         bv=zeros(a.n_kv_heads * hd))
            if a.qk_norm:
                q.update(q_norm=ones(hd), k_norm=ones(hd))
            return q

        def mlp(d_ff, d=d):
            return {"wg": dense(d, d_ff), "wu": dense(d, d_ff),
                    "wd": dense(d_ff, d), "ln": ones(d)}

        if cfg.ssm is not None:
            p["layers"] = [keep({"ssm": ssm_params(cfg, normal, dt,
                                                   self.device)},
                                "layers", i) for i in range(cfg.n_layers)]
            if cfg.arch_type == "hybrid":
                d2 = 2 * d
                p["shared"] = keep({"attn": attn(d2), "mlp": mlp(cfg.d_ff,
                                                                 d2),
                                    "down": dense(d2, d)}, "shared")
            return p
        if cfg.moe is None:
            p["layers"] = [keep({"attn": attn(), "mlp": mlp(cfg.d_ff)},
                                "layers", i) for i in range(cfg.n_layers)]
            return p
        m = cfg.moe

        def experts(d_in, d_out):
            t = dense(d_in, d_out, m.n_routed)
            if self.expert_group is None:
                return t
            return expert_rows(cfg, t, self.expert_group).clone()

        def moe():
            q = {"ln": ones(d),
                 "router": dense(d, m.n_routed, dtype=torch.float32),
                 "wg": experts(d, m.d_expert),
                 "wu": experts(d, m.d_expert),
                 "wd": experts(m.d_expert, d)}
            if m.n_shared:
                ds = m.n_shared * m.d_expert
                q.update(sh_wg=dense(d, ds), sh_wu=dense(d, ds),
                         sh_wd=dense(ds, d))
            return q

        p["dense_layers"] = [keep({"attn": attn(), "mlp": mlp(m.d_dense_ff)},
                                  "dense_layers", i)
                             for i in range(m.n_dense_layers)]
        p["moe_layers"] = [keep({"attn": attn(), "moe": moe()},
                                "moe_layers", i)
                           for i in range(cfg.n_layers - m.n_dense_layers)]
        if cfg.mtp_depth:
            p["mtp"] = keep({"proj": dense(2 * d, d), "ln_h": ones(d),
                             "ln_e": ones(d),
                             "layer": {"attn": attn(), "moe": moe()},
                             "ln_f": ones(d)}, "mtp")
        return p

    # ------------------------------------------------------------- FSDP
    def _lay(self, *path):
        """The FSDP layout of the subtree at ``path`` (None without
        FSDP)."""
        return None if self.fsdp is None else self.fsdp.at(*path)

    def _keep(self, tree, *path):
        """This rank's shards of the whole subtree ``tree`` at ``path``
        (``tree`` itself without FSDP)."""
        return tree if self.fsdp is None else self.fsdp.shard(tree, *path)

    def _gathers(self, p, key):
        """Per layer of ``p[key]``: its FSDP Gather (None without FSDP),
        for the layer's checkpoint policy to gather inside."""
        if self.fsdp is None:
            return [None] * len(p[key])
        return [self.fsdp.gather(lay) for lay in self.fsdp.layout[key]]

    def _whole(self, p, *path):
        """The subtree ``p[path]`` whole: under FSDP gathered on use,
        inside autograd (its gradient reduce-scattered to the shards)."""
        x = p
        for k in path:
            x = x[k]
        if self.fsdp is None:
            return x
        return self.fsdp.gather(self._lay(*path)).tree(x)

    def _serving(self):
        if self.fsdp is not None:
            raise ValueError("this model holds FSDP shards, which train; "
                             "serve parallel.fsdp.full_tree's whole tree "
                             "on a model built without fsdp")

    # ------------------------------------------------------------- head
    def _head(self, p, h):
        h = L.rms_norm(h, p["ln_f"], self.cfg.norm_eps)
        w = self._whole(p, "embed").T if self.cfg.tie_embeddings \
            else self._whole(p, "head")
        return h @ w.to(h.dtype)

    # ------------------------------------------------------------ train
    def _embed(self, p, batch):
        """This rank's rows of the embedded sequence: a VLM's image rows
        (``batch["image_embeds"]``, the prefix of its columns) then its
        token rows."""
        h = L.embed(self._whole(p, "embed"), batch["tokens"].to(self.device),
                    self.dtype)
        if self.cfg.arch_type != "vlm":
            return h
        img = batch["image_embeds"].to(device=self.device, dtype=self.dtype)
        return torch.cat([img, h], dim=1)

    def _prompt_embed(self, p, tokens, pos, pos_t, img=None):
        """The embedded rows at global positions ``pos`` (host integers;
        ``pos_t`` on the device) of a prompt (``tokens`` (B, Tt), after the
        image rows ``img`` (B, n, d) of a VLM): the image rows are a prefix
        of any rank's positions (module docstring)."""
        if img is None:
            return L.embed(p["embed"], tokens[:, pos_t], self.dtype)
        n = img.shape[1]
        k = int((pos < n).sum())
        return torch.cat([img[:, pos_t[:k]].to(self.dtype),
                          L.embed(p["embed"], tokens[:, pos_t[k:] - n],
                                  self.dtype)], dim=1)

    def _image_input(self, image_embeds, n_tokens: int):
        """A VLM prompt's image embeddings (this data replica's rows) and
        the prompt's whole length; None and ``n_tokens`` for a text-only
        model."""
        if (image_embeds is None) != (self.cfg.arch_type != "vlm"):
            raise ValueError(f"image embeddings are the input of a vlm "
                             f"model, and only of one "
                             f"({self.cfg.arch_type!r})")
        if image_embeds is None:
            return None, n_tokens
        img = self._rows(torch.as_tensor(image_embeds, device=self.device))
        return img, img.shape[1] + n_tokens

    def _backbone(self, p, h, cos, sin, seg=None):
        """The layers under the checkpoint policy; ``seg`` = packed-batch
        document ids (B, Tl) or None.  Returns ``(h, aux)``: the sum of the
        layers' load-balance losses in the reference's order (the dense
        layers' sum, plus the MoE layers' sum), or None for a dense-family
        model."""
        if self.cfg.ssm is not None:
            return self._ssm_trunk(p, h, cos, sin), None
        document = seg is not None
        if self.cfg.moe is None:
            layer = self._train_layer(False, document)
            gs = self._gathers(p, "layers")
            for lp, g in zip(p["layers"], gs):
                h = layer(lp, (h, cos, sin, seg), g)
            return h, None
        total = None
        for key, use_moe in (("dense_layers", False), ("moe_layers", True)):
            layer = self._train_layer(use_moe, document)
            aux = torch.zeros((), dtype=torch.float32, device=h.device)
            gs = self._gathers(p, key)
            for lp, g in zip(p[key], gs):
                h, a = layer(lp, (h, cos, sin, seg), g)
                aux = aux + a
            total = aux if total is None else total + aux
        return h, total

    def _train_layer(self, use_moe: bool, document: bool = False):
        """A training layer under ``par.remat``, its attention over
        :attr:`attn_group`; an MoE-family model's MoE over the expert
        groups (:func:`build_dense_layer`)."""
        kw = dict(document=document, P=self.seq_size, group=self.attn_group)
        if self.cfg.moe is not None:
            kw.update(use_moe=use_moe, all_group=self.moe_token_group,
                      experts=self.expert_group, rows=self.moe_rows)
        return build_dense_layer(self.cfg, self.par, self.impl, **kw)

    def _ssm_trunk(self, p, h, cos, sin):
        """The layers of an SSM or hybrid model on this rank's contiguous
        shard: Mamba2 mixers (``models/ssm.py``, the state relayed across
        the sequence group) under layer-boundary checkpointing for ``hf``
        and ``remat_aware`` (the paper's remat-aware placement is
        attention's), and after every ``hybrid_period`` of them a hybrid's
        shared block — a dense layer under ``par.remat`` on concat(h, the
        embedding output), 2·d_model wide, its attention through
        ``dist_flash_attn`` over the sequence group — added back through
        ``down``.  The shared block's parameters are one set for all G =
        n_layers / period calls, so their gradient sums over the calls."""
        cfg = self.cfg
        policy = "hf" if self.par.remat in ("hf", "remat_aware") else "none"
        layer = apply_policy(self._ssm_layer, policy)
        shared = None
        if cfg.arch_type == "hybrid":
            if cfg.n_layers % cfg.hybrid_period:
                raise ValueError(f"{cfg.n_layers} layers do not group by "
                                 f"the hybrid period {cfg.hybrid_period}")
            shared = build_dense_layer(self.shared_cfg, self.trunk_par,
                                       self.impl, P=self.seq_size,
                                       group=self.attn_group)
        emb0 = h
        gs = self._gathers(p, "layers")
        if shared is not None:
            sp = {k: p["shared"][k] for k in ("attn", "mlp")}
            sg = None if self.fsdp is None else self.fsdp.gather(
                {k: self._lay("shared", k) for k in ("attn", "mlp")})
        for i, (lp, g) in enumerate(zip(p["layers"], gs)):
            h = layer(lp, h, g)
            if shared is not None and (i + 1) % cfg.hybrid_period == 0:
                y2 = shared(sp, (torch.cat([h, emb0], dim=-1), cos, sin,
                                 None), sg)
                h = h + (y2 @ self._whole(p, "shared", "down")).to(h.dtype)
        return h

    def _ssm_layer(self, lp, h):
        return ssm_apply(lp["ssm"], h, self.cfg, self.seq_group)

    def positions(self, Tl: int) -> torch.Tensor:
        """Global positions of this rank's Tl tokens."""
        P = self.seq_size
        pos = shard_positions(Tl * P, P, self.seq_rank,
                              zigzag_layout(self.cfg, self.par, P))
        return torch.as_tensor(pos, device=self.device)

    def loss(self, p, batch):
        """Mean next-token cross-entropy of ``batch`` = {tokens, labels
        (B, Tl); optional segment_ids (B, Tl)}, this rank's shard, plus an
        MoE model's load-balance loss: ``(ce + aux, {"ce": ce, "aux":
        aux})`` (a dense model's aux is 0 and its loss is ce).  A VLM's
        batch adds this rank's ``image_embeds`` (B, n, d), the prefix of
        its columns, whose positions carry the label −100; its tokens and
        labels are then its text columns.  On a mesh
        the value is the global token mean, and its gradient is this rank's
        share of it (the train step sums gradients over
        :func:`token_group`); an MoE model's aux is the global value on
        every rank, its gradient again this rank's share."""
        cfg = self.cfg
        h = self._embed(p, batch)
        cos = sin = None
        if cfg.uses_attention:
            cos, sin = L.rope_tables(self.positions(h.shape[1]),
                                     self.rope_dim, cfg.attn.rope_theta)
        seg = batch.get("segment_ids")
        if seg is not None:
            if cfg.ssm is not None:
                raise ValueError(
                    f"packed (segment_ids) training is supported for "
                    f"dense/moe decoders, not {cfg.arch_type!r}")
            if cfg.mtp_depth:
                raise ValueError("packed training does not compose with "
                                 "MTP (the t+2 roll crosses documents)")
            seg = seg.to(self.device)
        h, aux = self._backbone(p, h, cos, sin, seg)
        ce = self._ce(self._head(p, h), self._labels(batch))
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=h.device)
            total = ce
        else:
            total = ce + aux
        metrics = {"ce": ce, "aux": aux}
        if cfg.mtp_depth and "mtp" in p:
            mtp_ce = self._mtp_loss(p, h, batch, cos, sin)
            total = total + 0.3 * mtp_ce
            metrics["mtp_ce"] = mtp_ce
        return total, metrics

    def _next_rows(self, x, labels: bool = False):
        """``x`` (B, Tl, ...) one position on along the global sequence:
        row t holds row t + 1, this rank's last row the next rank's first
        (the reference's ``jnp.roll(x, -1, axis=1)`` on the global array,
        whose last row wraps to the first).  A tensor in the graph crosses
        ranks by the differentiable shift, so its gradient returns to the
        rank that owns the row; ``labels`` (integers) by :meth:`Comm.shift`
        outside autograd, the global last position then set to −100."""
        g = self.seq_group
        if g is None or g.size == 1:
            nxt = x[:, :1]
        elif labels:
            nxt = g.shift([x[:, :1]], -1).wait()[0]
        else:
            nxt = comm_shift(g, x[:, :1], -1)
        out = torch.cat([x[:, 1:], nxt], dim=1)
        if labels and (g is None or g.rank == g.size - 1):
            out[:, -1] = -100
        return out

    def _mtp_loss(self, p, h, batch, cos, sin):
        """DeepSeek-V3 multi-token prediction [arXiv:2412.19437]: one extra
        MLA + MoE block predicts token t + 2 from (h_t, emb_{t+1}), ``h``
        the backbone's output before ``ln_f``; the block's load-balance
        loss is discarded, as the reference discards it.  On a mesh the
        t + 1 rows cross the shard edge (:meth:`_next_rows`); the last
        rank's wrapped row stays in the graph, its label −100."""
        cfg, mp, eps = self.cfg, p["mtp"], self.cfg.norm_eps
        emb = L.embed(self._whole(p, "embed"),
                      batch["tokens"].to(self.device), self.dtype)
        hcat = torch.cat([L.rms_norm(h, mp["ln_h"], eps),
                          L.rms_norm(self._next_rows(emb), mp["ln_e"], eps)],
                         dim=-1)
        h2 = (hcat @ self._whole(p, "mtp", "proj")).to(self.dtype)
        g = None if self.fsdp is None else self.fsdp.gather(
            self._lay("mtp", "layer"))
        h2, _aux = self._train_layer(True)(mp["layer"], (h2, cos, sin, None),
                                           g)
        h2 = L.rms_norm(h2, mp["ln_f"], eps)
        logits = h2 @ self._whole(p, "embed").T.to(h2.dtype)
        labels = self._next_rows(batch["labels"].to(self.device), True)
        return self._ce(logits, labels)

    def _labels(self, batch):
        """This rank's labels: a VLM's image positions (the prefix of its
        columns) carry −100, no loss."""
        labels = batch["labels"].to(self.device)
        if self.cfg.arch_type != "vlm":
            return labels
        return torch.cat([labels.new_full(batch["image_embeds"].shape[:2],
                                          -100), labels], dim=1)

    def _ce(self, logits, labels):
        """The mean cross-entropy over the tokens of every rank in
        :attr:`token_group` (labels −100 ignored); its gradient is this
        rank's share."""
        if self.token_group is None or self.token_group.size == 1:
            return L.cross_entropy(logits, labels)
        s, n = L.cross_entropy_sum(logits, labels)
        tot = torch.stack([s.detach(), n])
        self.token_group.all_reduce_([tot])
        total = tot[1].clamp(min=1.0)
        mine = s / total                 # its gradient: this rank's share
        return tot[0] / total + (mine - mine.detach())

    def _layer(self, lp, h, attend, cos, sin, decode: bool = False,
               latents=None, replicated: bool = False):
        """One layer with the attention ``attend(q, k, v) -> o`` (MLA
        materialised; ``latents``, a list, then takes the layer's latent
        rows); the FFN is :meth:`_ffn`'s."""
        if self.cfg.attn.is_mla:
            q, k, v, lat = L.mla_qkv(lp["attn"], h, self.cfg, cos, sin,
                                     return_latent=True)
            if latents is not None:
                latents.append(lat)
        else:
            q, k, v = L.attn_qkv(lp["attn"], h, self.cfg, cos, sin)
        h = L.attn_out(lp["attn"], h, attend(q, k, v), self.cfg)
        return self._ffn(lp, h, decode, replicated)

    def _ffn(self, lp, h, decode: bool = False, replicated: bool = False):
        """The layer's FFN with residual: a SwiGLU MLP, or the MoE — the
        capacity dispatch over ``h``'s rows (``replicated``: rows every
        sequence rank holds alike, :meth:`_split_moe`), or at ``decode``
        every expert on every row."""
        if "moe" not in lp:
            return L.mlp_apply(lp["mlp"], h, self.cfg.norm_eps)
        if decode:
            return moe_decode_apply(lp["moe"], h, self.cfg,
                                    group=self.expert_group)
        if replicated and self.expert_group is not None:
            return self._split_moe(lp["moe"], h)
        return moe_apply(lp["moe"], h, self.cfg, group=self.expert_group,
                         all_group=self.moe_token_group,
                         rows=self.moe_rows)[0]

    def _split_moe(self, p, h):
        """The capacity dispatch of rows (B, C, d) that every rank of the
        sequence group holds alike (a prefill chunk's): rank r dispatches
        its contiguous block of columns ``[r·C/S, (r+1)·C/S)`` over the
        expert group, each expert's capacity taken from those C/S rows, and
        the outputs are all-gathered back — the reference's ``shard_map``
        with ``in_specs P(b, seq_axis, None)``.  Its load-balance loss is
        not needed (serving) and not reduced."""
        g = self.expert_group
        C = h.shape[1]
        if C % g.size:
            raise ValueError(f"a chunk of {C} rows does not split over "
                             f"{g.size} sequence ranks")
        n = C // g.size
        y = moe_apply(p, h[:, g.rank * n:(g.rank + 1) * n], self.cfg,
                      group=g)[0]
        return g.all_gather(y.contiguous(), dim=1)

    # ------------------------------------------------------ absorbed MLA
    def _mla_parts(self, lp, h, cos, sin):
        """Absorbed-MLA projections of T tokens (the reference's
        ``_mla_decode_parts``): the latent-space query ``q_full`` (B, T,
        H, kv_lora + rope) — ``q_nope · W_uk`` in float32, cast back,
        beside the roped ``q_pe`` — the tokens' latent cache rows ``new``
        (B, T, kv_lora + rope), and the value up-projection ``W_uv``
        (kv_lora, H, v_head_dim)."""
        cfg, a, pa = self.cfg, self.cfg.attn, lp["attn"]
        B, T = h.shape[:2]
        nh, dn, dr = a.n_heads, a.qk_nope_head_dim, a.qk_rope_head_dim
        c, dv = a.kv_lora_rank, a.v_head_dim or a.head_dim
        hn = L.rms_norm(h, pa["ln"], cfg.norm_eps)
        if a.q_lora_rank:
            qc = L.rms_norm(hn @ pa["wq_a"], pa["q_ln"], cfg.norm_eps)
            q = (qc @ pa["wq_b"]).reshape(B, T, nh, dn + dr)
        else:
            q = (hn @ pa["wq"]).reshape(B, T, nh, dn + dr)
        q_pe = L.apply_rope(q[..., dn:], cos, sin)
        wkv_b = pa["wkv_b"].reshape(c, nh, dn + dv)
        q_eff = torch.einsum("bthn,chn->bthc", q[..., :dn].float(),
                             wkv_b[..., :dn].float()).to(h.dtype)
        kv_a = hn @ pa["wkv_a"]
        ckv = L.rms_norm(kv_a[..., :c], pa["kv_ln"], cfg.norm_eps)
        kpe = L.apply_rope(kv_a[..., c:].reshape(B, T, 1, dr), cos, sin)
        return (torch.cat([q_eff, q_pe], dim=-1),
                torch.cat([ckv, kpe[:, :, 0]], dim=-1), wkv_b[..., dn:])

    def _mla_out(self, lp, h, o_lat, w_uv):
        """Residual add of the latent output o_lat (B, T, H, kv_lora):
        up-projected by ``W_uv`` in float32, cast, then ``wo``."""
        B, T = h.shape[:2]
        o = torch.einsum("bthc,chv->bthv", o_lat.float(),
                         w_uv.float()).to(h.dtype)
        return h + (o.reshape(B, T, -1) @ lp["attn"]["wo"]).to(h.dtype)

    def _latent_layer(self, lp, h, cos, sin, attend, decode: bool):
        """One absorbed-MLA layer: ``attend(q_full, new) -> o_lat`` writes
        the tokens' latent rows and attends over the pool; its rows are the
        same on every rank (a chunk, or decode / verify rows)."""
        q_full, new, w_uv = self._mla_parts(lp, h, cos, sin)
        h = self._mla_out(lp, h, attend(q_full, new), w_uv)
        return self._ffn(lp, h, decode, replicated=True)

    # ------------------------------------------------------ plain forward
    @torch.no_grad()
    def forward(self, p, tokens, *, last_only: bool = False,
                image_embeds=None):
        """Whole-context forward, no cache, through the plain attention
        function (backend ``ref``) on any device: logits (B, T, V), or
        (B, 1, V) for the last position (a VLM's T counts its
        ``image_embeds`` rows first).  The oracle the paged path is held
        to.  MLA runs materialised; an MoE layer dispatches the whole
        context's rows at once, so its capacity drops differ from a chunked
        prefill's."""
        self._serving()
        a = self.cfg.attn
        tokens = torch.as_tensor(tokens, device=self.device)
        h = L.embed(p["embed"], tokens, self.dtype)
        if image_embeds is not None:
            h = torch.cat([torch.as_tensor(image_embeds, device=self.device)
                           .to(self.dtype), h], dim=1)
        T = h.shape[1]
        cos, sin = L.rope_tables(torch.arange(T, device=self.device),
                                 self.rope_dim, a.rope_theta)
        spec = decode_mask(a.window)

        def attend(q, k, v):
            return chunk_attn(q, k, v, mask=spec, scale=self.scale,
                              impl="ref")[0]

        for lp in layer_params(p):
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
        ``cache`` = {k_pool, v_pool (L, N, bs, Hkv, D) — or an MLA model's
        latent ``ckv_pool`` (L, N, bs, kv_lora + rope) — block_table (1,
        nkv) int32; optional ``shard``, this rank's part of a sharded pool};
        the pools are updated in place.  No logits: the last context token
        enters through decode.  MLA attends in latent space: kernel A with
        q (1, C, H, kv_lora + rope) over the gathered latent rows as the
        one kv head, v their first kv_lora columns (a view), at scale
        1/√(nope + rope).

        On a sharded pool the model runs replicated and each rank writes
        only its part: head-parallel, kernel A attends with this rank's q
        and kv heads and the outputs are all-gathered over heads;
        block-sharded (every latent pool across ranks), the owners' blocks
        are all-gathered and A attends over the whole pool, as GSPMD does
        for the reference.  Across sequence ranks the chunk's MoE splits
        its rows over them (:meth:`_split_moe`), so ``C`` must divide by
        their number."""
        self._serving()
        a = self.cfg.attn
        start, end = int(start), int(start) + int(n_valid)
        bt, shard = cache["block_table"], cache.get("shard")
        C = tokens.shape[1]
        h = L.embed(p["embed"], tokens, self.dtype)
        cos, sin = L.rope_tables(start + torch.arange(C, device=self.device),
                                 self.rope_dim, a.rope_theta)
        spec = decode_mask(a.window)
        rows = bt[0].long()
        tgt = _targets(*_chunk_rows(bt, _block_size(cache), C, start, end),
                       shard)
        if a.is_mla:
            c = a.kv_lora_rank
            for li, lp in enumerate(layer_params(p)):
                cp = cache["ckv_pool"][li]

                def attend(q, new, cp=cp):
                    _scatter(cp, new, tgt, shard)
                    g = gather_pool(cp, shard)[rows]
                    g = g.reshape(1, -1, 1, cp.shape[-1])
                    return chunk_attn(q, g, g[..., :c], mask=spec,
                                      scale=self.scale, q_offset=start,
                                      impl=self.impl)[0]

                h = self._latent_layer(lp, h, cos, sin, attend, False)
            return
        for li, lp in enumerate(layer_params(p)):
            kp, vp = cache["k_pool"][li], cache["v_pool"][li]

            def attend(q, k, v, kp=kp, vp=vp):
                _scatter(kp, k, tgt, shard)
                _scatter(vp, v, tgt, shard)
                kp, vp = gather_pool(kp, shard), gather_pool(vp, shard)
                kg = kp[rows].reshape(1, -1, *kp.shape[2:])
                vg = vp[rows].reshape(1, -1, *vp.shape[2:])
                if shard is None or shard.kind == "blocks":
                    return chunk_attn(q, kg, vg, mask=spec, q_offset=start,
                                      impl=self.impl)[0]
                g = shard.group
                hq = q.shape[2] // g.size
                o = chunk_attn(q[:, :, g.rank * hq:(g.rank + 1) * hq], kg,
                               vg, mask=spec, q_offset=start,
                               impl=self.impl)[0]
                return g.all_gather(o.contiguous(), dim=2)

            h = self._layer(lp, h, attend, cos, sin, replicated=True)

    # ---------------------------------------------- whole-prompt prefill
    @torch.no_grad()
    def prefill(self, p, tokens, image_embeds=None):
        """Whole-prompt forward of ``tokens`` (B, T) — the same global
        prompt on every rank; a VLM's prompt is ``image_embeds`` (B, n,
        d) then the tokens, T = n + their count — on this rank's shard of
        the sequence
        (``shard_positions``; zigzag: the rank's two mirror chunks), the
        attention through ``dist_attn_fwd`` under ``par.schedule`` (kernel
        A in the plan executors; at P = 1 one chunk call).  Returns the
        last prompt token's logits (B, 1, V), on every rank (broadcast from
        the rank holding that token), and this rank's dense cache shard
        ``{"k", "v"}`` (L, B, Tl, Hkv, D) in the stored order of the
        sequence (zigzag: the permuted order, as the reference's cache).
        When the batch shards over ``data`` (``par.batch_axes``) each data
        replica runs its own rows (:meth:`_rows`; the cache holds those
        rows) and the logits are gathered over ``data``.

        An MLA / MoE model runs MLA materialised (q/k of nope + rope, v of
        ``v_head_dim``: kernel A's pair route at scale 1/√(nope + rope)),
        the MoE capacity dispatch over this rank's B·Tl rows (its experts
        across the sequence group), and the cache ``{"ckv"}`` (L, B, Tl,
        kv_lora + rope) of each token's latent row, as the reference's
        ``_infer_layer_dense``.  With :attr:`latent_ring` under zigzag its
        attention ships those latent rows on the ring instead of K/V
        (``dist_attn_fwd_latent``).

        An SSM or hybrid model runs its training trunk on this rank's
        contiguous shard (the reference reuses ``_backbone``: the SSM's
        decode state is O(1), not a cache) and returns no cache, ``{}``;
        its decode starts from ``data.pipeline.empty_decode_cache``."""
        self._serving()
        if self.cfg.ssm is not None:
            h, cos, sin, pos, T = self._trunk_input(p, tokens)
            h = self._ssm_trunk(p, h, cos, sin)
            return self._last_logits(p, h, pos, T), {}
        a, P = self.cfg.attn, self.seq_size
        tokens = self._rows(torch.as_tensor(tokens, device=self.device))
        img, T = self._image_input(image_embeds, tokens.shape[1])
        zz = zigzag_layout(self.cfg, self.par, P)
        if T % (2 * P if zz else P):
            raise ValueError(f"prompt of {T} tokens does not shard over "
                             f"{P} ranks{' (zigzag: 2P chunks)' if zz else ''}")
        pos = shard_positions(T, P, self.seq_rank, zz)
        pos_t = torch.as_tensor(pos, device=self.device)
        h = self._prompt_embed(p, tokens, pos, pos_t, img)
        cos, sin = L.rope_tables(pos_t, self.rope_dim, a.rope_theta)
        spec = _attn_spec(self.cfg, self.par, P, self.impl, False,
                          self.scale, self.attn_group)
        ks, vs, latents = [], [], []
        ring = (a.is_mla and self.latent_ring
                and spec.schedule == "zigzag")
        expand = functools.partial(L.mla_expand, cfg=self.cfg)

        def attend(q, k, v, lp):
            if ring:
                return dist_attn_fwd_latent(
                    q, k, v, latents[-1], lp["attn"]["wkv_b"], expand,
                    spec=spec, group=self.seq_group)[0]
            if not a.is_mla:
                ks.append(k)
                vs.append(v)
            return dist_attn_fwd(q, k, v, spec=spec,
                                 group=self.attn_group)[0]

        for lp in layer_params(p):
            h = self._layer(lp, h, functools.partial(attend, lp=lp), cos,
                            sin, latents=latents)
        cache = ({"ckv": torch.stack(latents)} if a.is_mla else
                 {"k": torch.stack(ks), "v": torch.stack(vs)})
        return self._last_logits(p, h, pos, T), cache

    def _last_logits(self, p, h, pos, T):
        """The logits (B, 1, V) of position T − 1: the rank whose shard
        positions ``pos`` hold it computes them and broadcasts them over
        the sequence group; every data replica's rows, gathered."""
        P = self.seq_size
        zz = zigzag_layout(self.cfg, self.par, P)
        owner = next(r for r in range(P)
                     if (shard_positions(T, P, r, zz) == T - 1).any())
        if owner == self.seq_rank:
            i = int(np.nonzero(pos == T - 1)[0][0])
            logits = self._head(p, h[:, i:i + 1]).contiguous()
        else:
            logits = torch.empty((h.shape[0], 1, self.cfg.vocab),
                                 dtype=self.dtype, device=self.device)
        if self.seq_group is not None:
            self.seq_group.broadcast_([logits], owner)
        return self._all_rows(logits)

    def _trunk_input(self, p, tokens):
        """This rank's contiguous shard of ``tokens`` (the same global
        batch on every rank; this data replica's rows) through the
        embedding: (h, cos, sin, positions, T), the rope tables None for
        an attention-free model."""
        P = self.seq_size
        tokens = self._rows(torch.as_tensor(tokens, device=self.device))
        T = tokens.shape[1]
        if T % P:
            raise ValueError(f"{T} tokens do not shard over {P} ranks")
        pos = shard_positions(T, P, self.seq_rank)
        pos_t = torch.as_tensor(pos, device=self.device)
        h = L.embed(p["embed"], tokens[:, pos_t], self.dtype)
        cos = sin = None
        if self.cfg.uses_attention:
            cos, sin = L.rope_tables(pos_t, self.rope_dim,
                                     self.cfg.attn.rope_theta)
        return h, cos, sin, pos, T

    def _rows(self, x):
        """This data replica's contiguous share of the rows of ``x`` (all
        of them unless the batch shards over ``data``)."""
        g = self.batch_group
        if g is None:
            return x
        if x.shape[0] % g.size:
            raise ValueError(f"a batch of {x.shape[0]} does not shard over "
                             f"{g.size} data ranks")
        n = x.shape[0] // g.size
        return x[g.rank * n:(g.rank + 1) * n]

    def _all_rows(self, x):
        """The inverse of :meth:`_rows`: every replica's rows, gathered."""
        g = self.batch_group
        return x if g is None else g.all_gather(x.contiguous(), 0)

    def pad_cache(self, cache, S: int) -> dict:
        """This rank's shard of the prefill's global cache padded with
        zeros to ``S`` slots, in the decode layout: rank i of
        ``decode_group`` (the sequence axes ``par.seq_axes``) holds global
        slots ``[i·S/n, (i+1)·S/n)``, as the reference's padded cache
        sharded over those axes.  ``cache`` is :meth:`prefill`'s shard
        (Tl slots of the ``model`` axis; the same on every ``data``
        replica when ``data`` is one of the cache's axes).  The padded
        shard is longer than Tl, so each rank's tail moves to the ranks
        below it: a one-time exchange of the pieces, one ring shift per
        hop that carries any."""
        grp = self.decode_group
        n = 1 if grp is None else grp.size
        w = 0 if grp is None else grp.rank
        P = self.seq_size
        Tl = next(iter(cache.values())).shape[2]
        if S % n or S < Tl * P:
            raise ValueError(f"padded length {S} must divide over {n} "
                             f"shards and hold the {Tl * P} prompt slots")
        S_loc = S // n

        def take(dst, h):
            """The global slots [lo, hi) rank ``dst`` takes at hop ``h``,
            from rank dst + h (which holds prefill shard (dst + h) % P),
            unless an earlier hop's source held that shard; or None."""
            m = (dst + h) % n % P
            if any((dst + j) % n % P == m for j in range(h)):
                return None
            lo, hi = max(dst * S_loc, m * Tl), min((dst + 1) * S_loc,
                                                   (m + 1) * Tl)
            return (lo, hi) if lo < hi else None

        mine = w % P * Tl                     # my prefill shard's first slot
        out = {}
        for key, x in cache.items():
            out[key] = torch.zeros(x.shape[:2] + (S_loc,) + x.shape[3:],
                                   dtype=x.dtype, device=x.device)
        for h in range(n):
            spans = [take(d, h) for d in range(n)]
            M = max((b - a for a, b in filter(None, spans)), default=0)
            if not M:
                continue
            send, recv = spans[(w - h) % n], spans[w]
            if h == 0:
                if recv is None:
                    continue
                parts = {k: x[:, :, recv[0] - mine:recv[1] - mine]
                         for k, x in cache.items()}
            else:
                bufs = []
                for x in cache.values():
                    buf = x.new_zeros(x.shape[:2] + (M,) + x.shape[3:])
                    if send is not None:
                        buf[:, :, :send[1] - send[0]] = \
                            x[:, :, send[0] - mine:send[1] - mine]
                    bufs.append(buf)
                got = grp.shift(bufs, -h).wait()
                parts = dict(zip(cache, got))
            if recv is not None:
                lo, hi = recv
                for k, x in parts.items():
                    out[k][:, :, lo - w * S_loc:hi - w * S_loc] = \
                        x[:, :, :hi - lo]
        return out

    # ------------------------------------------------------------ decode
    @torch.no_grad()
    def decode(self, p, cache, token, pos):
        """One decode step: ``token`` (B, 1), ``pos`` (B,) int32
        per-request context lengths (the new token's position).  ``cache``
        is a paged view (``k_pool`` / ``v_pool`` + ``block_table``, and
        ``shard`` on a sharded pool, as :meth:`prefill_chunk`'s: per layer
        the new token's K/V is written into the request's current block,
        then kernel B attends through the block table) or this
        rank's dense shard ``{"k", "v"}`` (L, B, S_loc, Hkv, D) of a cache
        sharded over ``par.seq_axes`` (:meth:`pad_cache`: per layer
        ``dist_decode_attn`` over the shards, then :func:`_cache_write`
        into the owner shard; its rows are this data replica's, as
        :meth:`prefill`'s).  Returns logits (B, 1, V); the cache is
        updated in place.

        An MLA model's dense cache is :meth:`prefill`'s ``{"ckv"}``
        (L, B, S_loc, kv_lora + rope) padded by :meth:`pad_cache`: per
        layer the absorbed query (:meth:`_mla_parts`) attends the latent
        rows as one kv head with v their first kv_lora columns
        (``dist_decode_attn`` over the shards, plain float32), the token's
        latent row is written into the owner shard, the output is
        up-projected (:meth:`_mla_out`), and an MoE layer runs every expert
        (``moe_decode_apply``, its experts summed over the sequence group):
        the reference's ``_decode_mla``.

        An SSM or hybrid model's cache is
        ``data.pipeline.empty_decode_cache``'s (``state``, ``conv``; a
        hybrid's ``shared_k`` / ``shared_v`` too): :meth:`_decode_ssm`."""
        self._serving()
        if self.cfg.ssm is not None:
            return self._decode_ssm(p, cache, token, pos)
        a = self.cfg.attn
        if "block_table" in cache:
            return self._paged_layers(
                p, cache, token, pos[:, None],
                _decode_rows(cache["block_table"], _block_size(cache), pos))
        token, pos = self._rows(token), self._rows(pos)
        h = L.embed(p["embed"], token, self.dtype)
        cos, sin = L.rope_tables(pos, self.rope_dim, a.rope_theta)
        cos, sin = cos[:, None], sin[:, None]
        spec = decode_mask(a.window)
        if a.is_mla:
            c = a.kv_lora_rank
            for li, lp in enumerate(layer_params(p)):
                ck = cache["ckv"][li]

                def attend(q, new, ck=ck):
                    kv, new4 = ck[:, :, None], new[:, :, None]
                    o = dist_decode_attn(q, kv, kv[..., :c], new4,
                                         new4[..., :c],
                                         group=self.decode_group, mask=spec,
                                         scale=self.scale, pos=pos)
                    _cache_write(ck, new, pos, self.decode_group)
                    return o

                h = self._latent_layer(lp, h, cos, sin, attend, True)
            return self._all_rows(self._head(p, h))
        for li, lp in enumerate(layer_params(p)):
            ck, cv = cache["k"][li], cache["v"][li]

            def attend(q, k, v, ck=ck, cv=cv):
                o = dist_decode_attn(q, ck, cv, k, v,
                                     group=self.decode_group, mask=spec,
                                     pos=pos)
                _cache_write(ck, k, pos, self.decode_group)
                _cache_write(cv, v, pos, self.decode_group)
                return o

            h = self._layer(lp, h, attend, cos, sin, decode=True)
        return self._all_rows(self._head(p, h))

    def _decode_ssm(self, p, cache, token, pos):
        """One recurrent decode step of an SSM or hybrid model (the
        reference's ``decode`` / ``_decode_hybrid``): per layer
        ``ssm_decode_step`` on ``cache["state"][l]`` (B, nh, N, hd) float32
        and ``cache["conv"][l]`` (B, k − 1, ch), the same on every rank;
        after every ``hybrid_period`` layers the shared block on concat(h,
        the token's embedding), its attention reading group g's dense K/V
        ``cache["shared_k"][g]`` / ``["shared_v"][g]`` (B, S_loc, H, hd),
        sharded over ``par.seq_axes`` as :meth:`pad_cache`'s, through
        ``dist_decode_attn``, the token's k/v written into the owner shard.
        The cache is updated in place; returns logits (B, 1, V)."""
        cfg = self.cfg
        token, pos = self._rows(token), self._rows(pos)
        h = L.embed(p["embed"], token, self.dtype)
        cos = sin = None
        if cfg.uses_attention:
            cos, sin = L.rope_tables(pos, self.rope_dim, cfg.attn.rope_theta)
            cos, sin = cos[:, None], sin[:, None]
        emb0 = h
        for li, lp in enumerate(p["layers"]):
            h, cache["state"][li], cache["conv"][li] = ssm_decode_step(
                lp["ssm"], h, cache["state"][li], cache["conv"][li], cfg)
            if cfg.arch_type != "hybrid" or (li + 1) % cfg.hybrid_period:
                continue
            g, sp, scfg = (li // cfg.hybrid_period, p["shared"],
                           self.shared_cfg)
            ck, cv = cache["shared_k"][g], cache["shared_v"][g]
            x2 = torch.cat([h, emb0], dim=-1)
            q, k, v = L.attn_qkv(sp["attn"], x2, scfg, cos, sin)
            o = dist_decode_attn(q, ck, cv, k, v, group=self.decode_group,
                                 mask=mk.causal(), pos=pos)
            _cache_write(ck, k, pos, self.decode_group)
            _cache_write(cv, v, pos, self.decode_group)
            y2 = L.mlp_apply(sp["mlp"], L.attn_out(sp["attn"], x2, o, scfg),
                             cfg.norm_eps)
            h = h + (y2 @ sp["down"]).to(h.dtype)
        return self._all_rows(self._head(p, h))

    @torch.no_grad()
    def verify(self, p, cache, tokens, pos, n_write):
        """Speculative verification over a paged view: ``tokens`` (B, T),
        row t of request b at context position ``pos[b] + t`` (row 0 the
        pending token, rows 1.. draft proposals).  Per layer all T rows'
        K/V are written, then kernel B attends at ``lengths = pos + T``;
        only the first ``n_write[b]`` rows go to real blocks, the rest to
        the null block 0.  Token ids past the vocabulary (a draft with a
        wider one) read the last embedding row, as the reference's gather
        clamps.  With T = 1 and ``n_write = 1`` this is :meth:`decode`.
        Returns logits (B, T, V); the pools are updated in place."""
        self._serving()
        tokens = tokens.clamp(0, self.cfg.vocab - 1)
        rows = (pos.long()[:, None]
                + torch.arange(tokens.shape[1], device=pos.device))
        return self._paged_layers(
            p, cache, tokens, rows,
            _multi_rows(cache["block_table"], _block_size(cache), pos,
                        tokens.shape[1], n_write))

    def _paged_layers(self, p, cache, tokens, rows, dest):
        """The layers over a paged view for ``tokens`` (B, T) at context
        positions ``rows`` (B, T): per layer the rows' K/V go to pool
        blocks and offsets ``dest`` (two (B, T) tensors), then kernel B
        attends through the block table at ``lengths = rows[:, -1] + 1``
        (:func:`~repro_torch.serve.cache.sharded_paged_attn` when the view
        holds this rank's ``shard`` of a sharded pool).  MLA: kernel B with
        q (B, T, H, kv_lora + rope) over the latent pool as one kv head, v
        its first kv_lora columns (:func:`~repro_torch.serve.cache.
        sharded_latent_attn`: a block-sharded pool gathered first).
        Returns logits (B, T, V)."""
        a = self.cfg.attn
        B, T = tokens.shape
        h = L.embed(p["embed"], tokens, self.dtype)
        cos, sin = L.rope_tables(rows.reshape(-1), self.rope_dim,
                                 a.rope_theta)
        cos, sin = cos.reshape(B, T, -1), sin.reshape(B, T, -1)
        spec = decode_mask(a.window)
        bt, shard = cache["block_table"], cache.get("shard")
        tgt = _targets(*dest, shard)
        lengths = (rows[:, -1] + 1).to(torch.int32)
        if a.is_mla:
            c = a.kv_lora_rank
            for li, lp in enumerate(layer_params(p)):
                cp = cache["ckv_pool"][li]

                def attend(q, new, cp=cp):
                    _scatter(cp, new, tgt, shard)
                    return sharded_latent_attn(q, cp, c, bt, lengths, shard,
                                               mask=spec, scale=self.scale,
                                               impl=self.impl)

                h = self._latent_layer(lp, h, cos, sin, attend, True)
            return self._head(p, h)
        for li, lp in enumerate(layer_params(p)):
            kp, vp = cache["k_pool"][li], cache["v_pool"][li]

            def attend(q, k, v, kp=kp, vp=vp):
                _scatter(kp, k, tgt, shard)
                _scatter(vp, v, tgt, shard)
                if shard is None:
                    return paged_decode_attn(q, kp, vp, bt, lengths,
                                             mask=spec, impl=self.impl)
                return sharded_paged_attn(q, kp, vp, bt, lengths, shard,
                                          mask=spec, impl=self.impl)

            h = self._layer(lp, h, attend, cos, sin, decode=True)
        return self._head(p, h)


# --------------------------------------------------------------------------
# Whisper-style encoder–decoder (the conv frontend is a stub: batch["frames"]
# are precomputed frame embeddings) [arXiv:2212.04356]
# --------------------------------------------------------------------------

class EncDecLM(DecoderLM):
    """The reference's ``EncDecLM``: a non-causal encoder over the frames,
    run whole on every sequence rank (the frames are few beside the
    decoder's sequence), then decoder layers of causal self-attention —
    the distributed plan over the sequence ranks, the decoder's tokens
    sharded as a dense decoder's (zigzag falls back to balanced) — and
    cross-attention to the encoder output, local to each rank (kernel A
    under the full mask at Tq ≠ Tk; C and D in its backward).  Under
    ``remat_aware`` a decoder layer is two remat-aware sub-layers, the
    self-attention's and the cross-attention's with the MLP; each encoder
    layer is checkpointed whole.  Embeddings are tied.

    Across ranks every rank's decoder shard reads the whole encoder
    output, so the encoder's leaves and the cross ``wk`` / ``wv`` take a
    share of their gradient on every rank: the loss's gradient is this
    rank's share (:meth:`DecoderLM._ce`), and the train step sums every
    leaf over the sequence ranks once.  The decode cache is ``{"k", "v"}``
    sharded over ``par.seq_axes`` and the encoder's cross keys and values
    ``{"ek", "ev"}`` (L, B, F, H, hd), whole on every rank and never
    padded."""

    ARCHS = ("audio",)
    # the decoder's cross-attention mask: every query sees every frame
    cross_mask = mk.full()

    def init(self, seed: int = 0) -> dict:
        """Random parameters in the reference's tree — ``embed``,
        ``enc_layers`` (attn, mlp), ``dec_layers`` (attn, cross, mlp),
        ``ln_enc``, ``ln_f`` — by :meth:`DecoderLM.init`'s scheme; its bits
        differ from the reference's."""
        cfg, a, dt = self.cfg, self.cfg.attn, self.dtype
        gen = _generator(self.device, seed)
        d, hd, H = cfg.d_model, a.head_dim, a.n_heads

        def dense(d_in, d_out):
            x = _randn((d_in, d_out), gen, self.device)
            return (x / math.sqrt(d_in)).to(dt)

        def ones():
            return torch.ones(d, dtype=dt, device=self.device)

        def attn(kv_heads):
            return {"wq": dense(d, H * hd), "wk": dense(d, kv_heads * hd),
                    "wv": dense(d, kv_heads * hd), "wo": dense(H * hd, d),
                    "ln": ones()}

        def mlp():
            return {"wg": dense(d, cfg.d_ff), "wu": dense(d, cfg.d_ff),
                    "wd": dense(cfg.d_ff, d), "ln": ones()}

        keep = self._keep
        emb = _randn((cfg.vocab, d), gen, self.device)
        return {"embed": keep((emb * 0.02).to(dt), "embed"),
                "enc_layers": [keep({"attn": attn(a.n_kv_heads),
                                     "mlp": mlp()}, "enc_layers", i)
                               for i in range(cfg.n_enc_layers)],
                "dec_layers": [keep({"attn": attn(a.n_kv_heads),
                                     "cross": attn(H), "mlp": mlp()},
                                    "dec_layers", i)
                               for i in range(cfg.n_layers)],
                "ln_enc": ones(), "ln_f": ones()}

    # ---------------------------------------------------------- encoder
    def _full_attn(self, q, k, v, impl=None, mask=None):
        """Attention under ``mask`` (the full one by default),
        differentiable (kernel A forward, C and D backward)."""
        impl = self.impl if impl is None else impl
        mask = mk.full() if mask is None else mask
        return FlashAttnFn.apply(
            q, k, v,
            lambda q, k, v: chunk_attn(q, k, v, mask=mask, impl=impl),
            lambda q, k, v, o, lse, do: chunk_attn_bwd(
                q, k, v, o, lse, do, mask=mask, impl=impl))[0]

    def encode(self, p, frames, impl=None):
        """The encoder over ``frames`` (B, F, d): non-causal attention at
        Tq = Tk = F, each layer checkpointed whole, then ``ln_enc``."""
        cfg, a = self.cfg, self.cfg.attn
        h = torch.as_tensor(frames, device=self.device).to(self.dtype)
        cos, sin = L.rope_tables(torch.arange(h.shape[1],
                                              device=self.device),
                                 a.head_dim, a.rope_theta)

        def layer(lp, h, g=None):
            if g is not None:                   # FSDP: gathered on use
                lp = g.tree(lp)
            q, k, v = L.attn_qkv(lp["attn"], h, cfg, cos, sin)
            h2 = L.attn_out(lp["attn"], h, self._full_attn(q, k, v, impl),
                            cfg)
            return L.mlp_apply(lp["mlp"], h2, cfg.norm_eps)

        gs = self._gathers(p, "enc_layers")
        for lp, g in zip(p["enc_layers"], gs):
            h = (checkpoint(layer, lp, h, g, use_reentrant=False)
                 if torch.is_grad_enabled() else layer(lp, h, g))
        return L.rms_norm(h, p["ln_enc"], cfg.norm_eps)

    # ----------------------------------------------------- decoder layer
    def _cross_q(self, c, h):
        a = self.cfg.attn
        hn = L.rms_norm(h, c["ln"], self.cfg.norm_eps)
        return (hn @ c["wq"]).reshape(*h.shape[:2], a.n_heads, a.head_dim)

    def _cross_kv(self, c, enc):
        a = self.cfg.attn
        shape = (*enc.shape[:2], a.n_heads, a.head_dim)
        return (enc @ c["wk"]).reshape(shape), (enc @ c["wv"]).reshape(shape)

    def _cross_out(self, lp, h, o):
        """The cross-attention's residual add through ``wo``, then the
        MLP."""
        h2 = h + (o.reshape(*h.shape[:2], -1)
                  @ lp["cross"]["wo"]).to(h.dtype)
        return L.mlp_apply(lp["mlp"], h2, self.cfg.norm_eps)

    def _dec_layer(self):
        """``layer(params, (h, enc, cos, sin), gather=None) -> h'`` under
        ``par.remat``: the self-attention over the sequence ranks, then
        the cross-attention with the MLP; ``gather`` a layer's FSDP
        :class:`~repro_torch.parallel.fsdp.Gather` (``core/remat.py``)."""
        cfg, group, impl = self.cfg, self.attn_group, self.impl
        spec = _attn_spec(cfg, self.par, self.seq_size, impl, False,
                          group=group)
        cross = self.cross_mask

        def pre_self(lp, x):
            return L.attn_qkv(lp["attn"], x[0], cfg, x[1], x[2])

        def self_fwd(qkv):
            return dist_attn_fwd(*qkv, spec=spec, group=group, for_bwd=True)

        def self_bwd(qkv, o, lse, do):
            return dist_attn_bwd(*qkv, o, lse, do, spec=spec, group=group)

        def post_self(lp, x, o):
            return L.attn_out(lp["attn"], x[0], o, cfg)

        def pre_cross(lp, x):
            return (self._cross_q(lp["cross"], x[0]),
                    *self._cross_kv(lp["cross"], x[1]))

        def cross_fwd(qkv):
            return chunk_attn(*qkv, mask=cross, impl=impl)

        def cross_bwd(qkv, o, lse, do):
            return chunk_attn_bwd(*qkv, o, lse, do, mask=cross, impl=impl)

        def post_cross(lp, x, o):
            return self._cross_out(lp, x[0], o)

        if self.par.remat == "remat_aware":
            # the two sub-layers gather their own leaves: the self
            # attention's, then the cross-attention's with the MLP's
            sub_a = remat_aware(pre_self, self_fwd, self_bwd, post_self)
            sub_b = remat_aware(pre_cross, cross_fwd, cross_bwd, post_cross)

            def split(tree):
                return ({"attn": tree["attn"]},
                        {k: tree[k] for k in ("cross", "mlp")})

            def layer(lp, x, gather=None):
                (pa, pb), ga, gb = split(lp), None, None
                if gather is not None:
                    la, lb = split(gather.lay)
                    ga, gb = gather.sub(la), gather.sub(lb)
                return sub_b(pb, (sub_a(pa, (x[0], x[2], x[3]), ga), x[1]),
                             gb)
            return layer

        def plain(lp, x):
            h, enc, cos, sin = x
            o, _ = dist_flash_attn(*pre_self(lp, (h, cos, sin)), spec,
                                   group)
            h = post_self(lp, (h,), o)
            return self._cross_out(lp, h, self._full_attn(
                *pre_cross(lp, (h, enc)), mask=cross))

        return apply_policy(plain, self.par.remat)

    # ------------------------------------------------------------ train
    def loss(self, p, batch):
        """Mean next-token cross-entropy of ``batch`` = {frames (B, F, d),
        the whole clip; tokens, labels (B, Tl), this rank's shard}:
        ``(ce, {"ce": ce, "aux": 0})``.  On a mesh the value is the global
        token mean and its gradient this rank's share, the encoder's
        included."""
        cfg, a = self.cfg, self.cfg.attn
        enc = self.encode(p, batch["frames"])
        h = L.embed(self._whole(p, "embed"), batch["tokens"].to(self.device),
                    self.dtype)
        cos, sin = L.rope_tables(self.positions(h.shape[1]), a.head_dim,
                                 a.rope_theta)
        layer = self._dec_layer()
        gs = self._gathers(p, "dec_layers")
        for lp, g in zip(p["dec_layers"], gs):
            h = layer(lp, (h, enc, cos, sin), g)
        ce = self._ce(self._head(p, h), batch["labels"].to(self.device))
        return ce, {"ce": ce, "aux": torch.zeros(
            (), dtype=torch.float32, device=h.device)}

    # ---------------------------------------------------------- serving
    @torch.no_grad()
    def forward(self, p, tokens, *, frames, last_only: bool = False):
        """Whole-context forward, no cache, through the plain attention
        function (backend ``ref``) on any device: logits (B, T, V), or
        (B, 1, V) for the last position."""
        self._serving()
        a = self.cfg.attn
        tokens = torch.as_tensor(tokens, device=self.device)
        enc = self.encode(p, frames, impl="ref")
        h = L.embed(p["embed"], tokens, self.dtype)
        cos, sin = L.rope_tables(torch.arange(tokens.shape[1],
                                              device=self.device),
                                 a.head_dim, a.rope_theta)
        for lp in p["dec_layers"]:
            q, k, v = L.attn_qkv(lp["attn"], h, self.cfg, cos, sin)
            h = L.attn_out(lp["attn"], h, chunk_attn(
                q, k, v, mask=decode_mask(a.window), impl="ref")[0],
                self.cfg)
            o = chunk_attn(self._cross_q(lp["cross"], h),
                           *self._cross_kv(lp["cross"], enc),
                           mask=mk.full(), impl="ref")[0]
            h = self._cross_out(lp, h, o)
        return self._head(p, h[:, -1:] if last_only else h)

    @torch.no_grad()
    def prefill(self, p, tokens, frames):
        """The encoder over ``frames`` (B, F, d), then the decoder over
        ``tokens`` (B, T) — the same on every rank — on this rank's
        contiguous shard, its self-attention through ``dist_attn_fwd``
        under ``par.schedule``.  Returns the last prompt token's logits
        (B, 1, V) on every rank and the cache ``{"k", "v"}`` (L, B, Tl,
        H, hd), this rank's shard, with ``{"ek", "ev"}`` (L, B, F, H,
        hd), the encoder's cross keys and values, whole."""
        self._serving()
        a, P = self.cfg.attn, self.seq_size
        enc = self.encode(p, self._rows(torch.as_tensor(
            frames, device=self.device)))
        tokens = self._rows(torch.as_tensor(tokens, device=self.device))
        T = tokens.shape[1]
        if T % P:
            raise ValueError(f"prompt of {T} tokens does not shard over "
                             f"{P} ranks")
        pos = shard_positions(T, P, self.seq_rank)
        pos_t = torch.as_tensor(pos, device=self.device)
        h = L.embed(p["embed"], tokens[:, pos_t], self.dtype)
        cos, sin = L.rope_tables(pos_t, a.head_dim, a.rope_theta)
        spec = _attn_spec(self.cfg, self.par, P, self.impl, False,
                          group=self.attn_group)
        cache = {"k": [], "v": [], "ek": [], "ev": []}
        for lp in p["dec_layers"]:
            q, k, v = L.attn_qkv(lp["attn"], h, self.cfg, cos, sin)
            h = L.attn_out(lp["attn"], h, dist_attn_fwd(
                q, k, v, spec=spec, group=self.attn_group)[0], self.cfg)
            ek, ev = self._cross_kv(lp["cross"], enc)
            o = chunk_attn(self._cross_q(lp["cross"], h), ek, ev,
                           mask=self.cross_mask, impl=self.impl)[0]
            h = self._cross_out(lp, h, o)
            for key, t in (("k", k), ("v", v), ("ek", ek), ("ev", ev)):
                cache[key].append(t)
        return (self._last_logits(p, h, pos, T),
                {key: torch.stack(ts) for key, ts in cache.items()})

    def pad_cache(self, cache, S: int) -> dict:
        """:meth:`DecoderLM.pad_cache` of ``k`` / ``v``; ``ek`` / ``ev``
        stay whole and unpadded (the reference's ``_PAD_KEYS``)."""
        out = super().pad_cache({k: cache[k] for k in ("k", "v")}, S)
        out.update(ek=cache["ek"], ev=cache["ev"])
        return out

    @torch.no_grad()
    def decode(self, p, cache, token, pos):
        """One decode step on :meth:`pad_cache`'s layout: per layer the
        self-attention through ``dist_decode_attn`` over the ``k`` / ``v``
        shards (the token's k/v written into the owner shard), then the
        cross-attention at Tq = 1 against the layer's ``ek`` / ``ev``
        (kernel A, full mask).  Returns logits (B, 1, V); the cache is
        updated in place."""
        self._serving()
        a = self.cfg.attn
        token, pos = self._rows(token), self._rows(pos)
        h = L.embed(p["embed"], token, self.dtype)
        cos, sin = L.rope_tables(pos, a.head_dim, a.rope_theta)
        cos, sin = cos[:, None], sin[:, None]
        for li, lp in enumerate(p["dec_layers"]):
            ck, cv = cache["k"][li], cache["v"][li]
            q, k, v = L.attn_qkv(lp["attn"], h, self.cfg, cos, sin)
            o = dist_decode_attn(q, ck, cv, k, v, group=self.decode_group,
                                 mask=decode_mask(a.window), pos=pos)
            _cache_write(ck, k, pos, self.decode_group)
            _cache_write(cv, v, pos, self.decode_group)
            h = L.attn_out(lp["attn"], h, o, self.cfg)
            o = chunk_attn(self._cross_q(lp["cross"], h), cache["ek"][li],
                           cache["ev"][li], mask=self.cross_mask,
                           impl=self.impl)[0]
            h = self._cross_out(lp, h, o)
        return self._all_rows(self._head(p, h))


def build_model(cfg: ModelConfig, device="cuda", **kw):
    """The model class of ``cfg``'s family: :class:`EncDecLM` for an
    encoder–decoder, else :class:`DecoderLM` (keywords as theirs)."""
    cls = EncDecLM if cfg.arch_type == "audio" else DecoderLM
    return cls(cfg, device, **kw)


# --------------------------------------------------------------------------
# Paged-cache writes: scatter new K/V through the block table, in place
# --------------------------------------------------------------------------

def _block_size(cache) -> int:
    """The block size of a paged view's pools (L, N, bs, ...)."""
    pool = cache["ckv_pool"] if "ckv_pool" in cache else cache["k_pool"]
    return pool.shape[2]


def _decode_rows(block_table, bs: int, pos):
    """Pool block and offset (B, 1) of each request's new token at context
    position ``pos`` (B,): block ``block_table[b, pos_b // bs]``, offset
    ``pos_b % bs``.  Idle rows (all-zero table rows) land in the null block
    0."""
    pos = pos.long()
    bidx = block_table.long().gather(1, (pos // bs)[:, None])
    return bidx, (pos % bs)[:, None]


def _multi_rows(block_table, bs: int, pos, T: int, n_write):
    """Pool blocks and offsets (B, T) of ``T`` rows a request: row t of
    request b holds context position ``pos_b + t``; rows with ``t >=
    n_write_b`` (draft slack, idle rows with ``n_write = 0``) go to the
    null block 0."""
    nb = block_table.shape[1]
    t = torch.arange(T, device=block_table.device)
    idx = pos.long()[:, None] + t[None, :]                        # (B, T)
    col = torch.clamp(idx // bs, 0, nb - 1)
    bidx = block_table.long().gather(1, col)
    bidx = torch.where(t[None, :] < n_write.long()[:, None], bidx,
                       torch.zeros_like(bidx))
    return bidx, idx % bs


def _chunk_rows(block_table, bs: int, C: int, start: int, end: int):
    """Pool blocks and offsets (1, C) of a B=1 chunk: row ``i`` holds
    context position ``start + i``; rows at positions ``>= end`` (bucket
    padding) go to the null block 0."""
    idx = start + torch.arange(C, device=block_table.device)
    col = torch.clamp(idx // bs, 0, block_table.shape[1] - 1)
    bidx = torch.where(idx < end, block_table[0].long()[col],
                       torch.zeros_like(idx))
    return bidx[None], (idx % bs)[None]


def _targets(bidx, off, shard=None):
    """Where this rank writes rows bound for pool blocks ``bidx`` (global
    ids) at offsets ``off`` (both (B, T)): ``(kept rows or None, local
    blocks, offsets)`` over the flattened rows.  A block-sharded pool keeps
    only the rows whose block this rank holds (the others go nowhere, not
    to a local id); the null block 0 lives on group rank 0.  Computed once
    a forward, for every layer's writes."""
    bidx, off = bidx.reshape(-1), off.reshape(-1)
    if shard is None or shard.kind != "blocks":
        return None, bidx, off
    local = bidx - shard.lo
    keep = ((local >= 0) & (local < shard.n_local)).nonzero()[:, 0]
    return keep, local[keep], off[keep]


def _scatter(pool, new, tgt, shard=None):
    """Write the rows of ``new`` (B, T, Hkv, D) into ``pool`` (N, bs, ...)
    at :func:`_targets` ``tgt``; a head-parallel pool takes this rank's kv
    heads."""
    keep, bidx, off = tgt
    x = new.reshape((-1,) + tuple(new.shape[2:]))     # (B·T, ...)
    if shard is not None and shard.kind == "heads":
        x = x[:, shard.lo:shard.lo + shard.n_local]
    if keep is not None:
        x = x[keep]
    pool.index_put_((bidx, off), x.to(pool.dtype))


def _cache_write(cache, new, pos, group=None):
    """Write ``new`` (B, 1, ...) into this rank's shard ``cache``
    (B, S_loc, ...) of a cache sharded over the ranks of ``group`` (None:
    one shard), in place, at each request's ring-buffer slot
    ``pos[b] % (n·S_loc)`` (``pos`` (B,), or a scalar that broadcasts):
    only the shard that owns the slot writes.  No host sync: every row
    is read and written back, unchanged where this shard is not the
    owner."""
    n = 1 if group is None else group.size
    idx = 0 if group is None else group.rank
    B, S_loc = cache.shape[:2]
    pos = torch.as_tensor(pos, device=cache.device).long().expand(B)
    slot = pos % (n * S_loc)
    local = slot % S_loc
    hit = (slot // S_loc == idx).view((B,) + (1,) * (cache.ndim - 2))
    b = torch.arange(B, device=cache.device)
    cache[b, local] = torch.where(hit, new[:, 0].to(cache.dtype),
                                  cache[b, local])


# --------------------------------------------------------------------------
# Weights importer
# --------------------------------------------------------------------------

# the stacked layer groups of the reference's tree, in order
_LAYER_KEYS = LAYER_KEYS
# leaves the reference keeps in float32 whatever the model's dtype
_FLOAT32_LEAVES = ("router", "A_log", "D", "dt_bias")
# subtrees held once, not stacked by layer: a hybrid's shared block, and
# the MTP block (``proj``, its norms and one MLA + MoE ``layer``)
_ONCE_KEYS = ONCE_KEYS


def _map_named(fn, tree, group="", name=""):
    """``fn(leaf, name, group)`` on every leaf of nested dicts, ``name`` the
    leaf's key and ``group`` its parent's (:func:`is_expert_leaf`'s
    pair)."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, name, k) for k, v in tree.items()}
    return fn(tree, name, group)


def load_reference_params(cfg: ModelConfig, tree: dict, device="cuda",
                          dtype: Optional[torch.dtype] = None, *,
                          experts=None, fsdp=None) -> dict:
    """Carry the reference ``DecoderLM.init`` pytree into the port's layout.

    ``tree`` is nested dicts of numpy arrays with the layers stacked on a
    leading ``L`` axis (``tree["layers"]["attn"]["wq"]`` is (L, d, H·hd);
    an MoE model's ``dense_layers`` and ``moe_layers`` alike); returns the
    port's parameters (lists of per-layer dicts) on ``device`` in ``dtype``
    (default: the config's).  The MoE router stays float32, as the
    reference keeps it.  ``experts`` is the Comm the routed experts shard
    over (``DecoderLM.expert_group``; None: all here): each rank keeps its
    rows of them.  An SSM's ``A_log``, ``D`` and ``dt_bias`` stay float32,
    as the reference keeps them; a hybrid's ``shared`` block and the MTP
    block (``mtp``, its routed experts sharded like the MoE layers') are
    one set of leaves each, not stacked, and not counted as layers.  An
    encoder–decoder's tree has ``enc_layers`` and
    ``dec_layers`` (each with its ``cross`` block) and ``ln_enc``.
    ``fsdp`` (a model's ``parallel.fsdp.FSDP``): each rank keeps its
    shards, cut as each layer or top-level subtree is carried over."""
    dt = dtype if dtype is not None else DTYPES[cfg.dtype]

    def keep(sub, *path):
        return sub if fsdp is None else fsdp.shard(sub, *path)

    def t(x, name="", grp=""):
        x = np.asarray(x)
        if is_expert_leaf(grp, name):
            x = expert_rows(cfg, x, experts)
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(
            device=device,
            dtype=torch.float32 if name in _FLOAT32_LEAVES else dt)

    p = {k: keep(t(tree[k]), k) for k in ("embed", "ln_f", "head", "ln_enc")
         if k in tree}
    for key in _ONCE_KEYS:
        if key in tree:
            p[key] = keep(_map_named(t, tree[key], name=key), key)
    n_all = 0
    for key in _LAYER_KEYS:
        if key not in tree:
            continue
        stacked = tree[key]
        n = len(next(iter(next(iter(stacked.values())).values())))
        p[key] = [keep({grp: {name: t(arr[i], name, grp)
                              for name, arr in stacked[grp].items()}
                         for grp in stacked}, key, i) for i in range(n)]
        n_all += n
    if n_all != cfg.n_layers + cfg.n_enc_layers:
        raise ValueError(f"tree has {n_all} layers, config "
                         f"{cfg.n_layers + cfg.n_enc_layers}")
    return p


def to_reference_params(params: dict, *, experts=None, fsdp=None) -> dict:
    """The inverse of :func:`load_reference_params`: the port's parameters
    in the reference's pytree layout, every layer leaf stacked on a leading
    ``L`` axis (same dtype and device).  ``experts``: the Comm the routed
    experts shard over, whose shards are gathered (every rank of it must
    call), so each rank returns the global tree.  ``fsdp`` (a model's
    ``parallel.fsdp.FSDP``): ``params`` are FSDP shards, gathered first
    (every rank of the FSDP group must call)."""
    if fsdp is not None:
        params = fsdp.full(params)

    def leaf(x, name, grp):
        x = x.detach()
        if is_expert_leaf(grp, name) and experts is not None:
            x = experts.all_gather(x.contiguous(), 0)
        return x

    out = {k: (_map_named(leaf, v, name=k) if k in _ONCE_KEYS else v)
           for k, v in params.items() if k not in _LAYER_KEYS}
    for key in _LAYER_KEYS:
        if key not in params:
            continue
        layers = params[key]
        out[key] = {grp: {name: torch.stack([leaf(lp[grp][name], name, grp)
                                             for lp in layers])
                          for name in layers[0][grp]}
                    for grp in layers[0]}
    return out


def load_reference_opt_state(cfg: ModelConfig, state, device="cuda", *,
                             experts=None, fsdp=None) -> AdamWState:
    """Carry the reference ``AdamWState`` (``step``, and ``m``/``v`` trees
    of numpy arrays in the reference's parameter layout) into the port's
    :class:`~repro_torch.optim.adamw.AdamWState` with float32 moments
    (``experts`` and ``fsdp`` as :func:`load_reference_params`'s)."""
    step, m, v = state
    return AdamWState(
        step=int(np.asarray(step)),
        m=load_reference_params(cfg, m, device, torch.float32,
                                experts=experts, fsdp=fsdp),
        v=load_reference_params(cfg, v, device, torch.float32,
                                experts=experts, fsdp=fsdp))

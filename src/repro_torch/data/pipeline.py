"""Synthetic training data (port of the reference ``data/pipeline.py``:
``SyntheticTokens`` for dense, VLM, MoE, SSM and hybrid decoders and the
encoder–decoder), the empty decode cache of an SSM or hybrid model
(:func:`empty_decode_cache`) and the encoder–decoder's decode-cache shapes
(:func:`audio_cache_shapes`): the reference's ``cache_specs`` arms for
them, and :func:`input_specs`, one rank's inputs of a step on the ``meta``
device for the dry-run (the reference's shape-only specs).

A VLM's batch of ``seq_len`` T positions is ``n_image_tokens`` image
embeddings — standard normals from ``np.random.default_rng(step)``, in the
model's dtype — then T − n text tokens; an encoder–decoder's adds the
clip's ``frames`` (B, n_audio_frames, d_model), drawn the same way, to T
tokens.

The tokens are the reference's, bit for bit: the same numpy generator, seed
and step give the same hash-mixed Markov stream, and with ``shape.docs > 1``
the same packed layout (``mask.doc_boundaries``), ``segment_ids`` and
``-100`` labels at each document's last token.  They are returned as int32
torch tensors on an explicit device.

On a process-group mesh each rank gets its (data, seq) shard of the same
global batch: rows by its ``data`` coordinate (when the batch shards over
``data``), columns by the global positions it holds (contiguous, or the
zigzag layout under the zigzag schedule) — on a 2D mesh its slice of the
(seq, head) pair, seq major.  Labels are shifted before
sharding, so a shard's last label is the next shard's first token.  A
VLM's columns are positions of the concatenated (image, text) sequence:
a rank gets the image rows and the text tokens and labels its columns
hold (the image rows a prefix of them).  The frames are not sharded over
the sequence: every rank gets the whole clip of its rows.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.config import ModelConfig, ParallelConfig, ShapeSpec
from repro_torch.core.dist_attention import shard_positions
from repro_torch.core.mask import doc_boundaries, segments_from_boundaries
from repro_torch.parallel.sharding import batch_group, seq_group


@dataclasses.dataclass
class SyntheticTokens:
    """Reproducible pseudo-text: a Markov chain over the vocabulary that is
    learnable and fully determined by (seed, step).  When ``shape.docs >
    1`` each sequence packs ``docs`` independent documents and the batch
    gains ``segment_ids``.  With a ``mesh`` (and the run's ``par``) a
    batch is this rank's shard."""
    cfg: ModelConfig
    shape: ShapeSpec
    device: str = "cuda"
    seed: int = 0
    mesh: object = None
    par: ParallelConfig = None

    def _tokens(self, step: int, B: int, T: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 1_000_003 + step)
        v = min(self.cfg.vocab, 1024)
        x = np.empty((B, T + 1), np.int64)
        x[:, 0] = rng.integers(0, v, B)
        rng.integers(1, v)           # the reference draws (and drops) this
        for t in range(T):
            noise = rng.integers(0, v, B)
            x[:, t + 1] = np.where(rng.random(B) < 0.8,
                                   (x[:, t] * 31 + 7) % v, noise)
        return x.astype(np.int32)

    def _packed(self, step: int, B: int, T: int):
        """(tokens, labels, segment_ids), all (B, T) int32."""
        bnd = doc_boundaries(T, self.shape.docs)
        seg = np.tile(segments_from_boundaries(T, bnd), (B, 1))
        tokens = np.empty((B, T), np.int32)
        labels = np.full((B, T), -100, np.int32)
        ends = list(bnd[1:]) + [T]
        for d, (b0, b1) in enumerate(zip(bnd, ends)):
            stream = self._tokens(step * 8191 + d, B, b1 - b0 - 1)
            tokens[:, b0:b1] = stream
            labels[:, b0:b1 - 1] = stream[:, 1:]     # last token: no target
        return tokens, labels, seg

    def _embeds(self, step: int, B: int, n: int) -> torch.Tensor:
        """(B, n, d_model) standard normals from ``default_rng(step)`` in
        the model's dtype: the stub frontend's image or frame rows."""
        from repro_torch.models.transformer import DTYPES
        x = np.random.default_rng(step).standard_normal(
            (B, n, self.cfg.d_model)).astype(np.float32)
        return torch.from_numpy(x).to(DTYPES[self.cfg.dtype])

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        B, T = self.shape.global_batch, self.shape.seq_len

        rows, cols = self._shard(B, T)

        def t(x, cols=cols):
            return torch.from_numpy(np.ascontiguousarray(
                x[rows][:, cols])).to(self.device)

        if cfg.arch_type == "vlm":
            n = cfg.n_image_tokens
            x = self._tokens(step, B, T - n)
            img = self._embeds(step, B, n)[rows]
            return {"tokens": t(x[:, :-1], cols[cols >= n] - n),
                    "labels": t(x[:, 1:], cols[cols >= n] - n),
                    "image_embeds": img[:, cols[cols < n]].to(self.device)}
        if cfg.arch_type == "audio":
            x = self._tokens(step, B, T)
            frames = self._embeds(step, B, cfg.n_audio_frames)[rows]
            return {"tokens": t(x[:, :-1]), "labels": t(x[:, 1:]),
                    "frames": frames.to(self.device)}
        if self.shape.kind == "train" and self.shape.docs > 1:
            tokens, labels, seg = self._packed(step, B, T)
            return {"tokens": t(tokens), "labels": t(labels),
                    "segment_ids": t(seg)}
        x = self._tokens(step, B, T)
        return {"tokens": t(x[:, :-1]), "labels": t(x[:, 1:])}

    def _shard(self, B: int, T: int):
        """This rank's (row slice, column positions) of the global batch."""
        if self.mesh is None:
            return slice(None), np.arange(T)
        from repro_torch.models.transformer import zigzag_layout
        par = ParallelConfig() if self.par is None else self.par
        rows = slice(None)
        bg = batch_group(self.mesh, par)
        if bg is not None:
            D, d = bg.size, bg.rank
            rows = slice(d * B // D, (d + 1) * B // D)
        g = seq_group(self.mesh, par)
        cols = shard_positions(T, g.size, g.rank,
                               zigzag_layout(self.cfg, par, g.size))
        return rows, cols


def audio_cache_shapes(cfg: ModelConfig, batch: int, seq_len: int,
                       shards: int = 1) -> dict:
    """The encoder–decoder's decode cache as ``{key: (shape, dtype)}``, the
    reference's ``cache_specs`` arm on this rank: ``k`` / ``v`` (L, B,
    seq_len / shards, H_kv, head_dim), its shard of a cache sharded over
    the sequence axes, and the cross keys and values ``ek`` / ``ev`` (L,
    B, n_audio_frames, H, head_dim), whole on every rank — what
    ``EncDecLM.prefill`` then ``pad_cache`` hold."""
    from repro_torch.models.transformer import DTYPES
    if cfg.arch_type != "audio":
        raise ValueError(f"{cfg.arch_type!r} is not an encoder-decoder")
    if seq_len % shards:
        raise ValueError(f"{seq_len} cache slots do not shard over "
                         f"{shards} ranks")
    a, L, dt = cfg.attn, cfg.n_layers, DTYPES[cfg.dtype]
    kv = (L, batch, seq_len // shards, a.n_kv_heads, a.head_dim)
    cross = (L, batch, cfg.n_audio_frames, a.n_heads, a.head_dim)
    return {"k": (kv, dt), "v": (kv, dt), "ek": (cross, dt),
            "ev": (cross, dt)}


def empty_decode_cache(cfg: ModelConfig, batch: int, seq_len: int = 0,
                       device="cuda", shards: int = 1) -> dict:
    """The zero decode cache of an SSM or hybrid model on ``device``, shaped
    as the reference's ``cache_specs``: ``state`` (L, B, nh, d_state,
    head_dim) float32 and ``conv`` (L, B, d_conv − 1, d_inner + 2·d_state)
    in the model's dtype, replicated on every rank; a hybrid's
    ``shared_k`` / ``shared_v`` (G, B, S_loc, H_kv, head_dim) for its G =
    n_layers / hybrid_period shared-block calls, this rank's ``seq_len /
    shards`` slots of a cache sharded over the sequence axes."""
    from repro_torch.models.transformer import DTYPES
    if cfg.ssm is None:
        raise ValueError(f"{cfg.arch_type!r} models decode from their "
                         "prefill's cache")
    s, d, dt = cfg.ssm, cfg.d_model, DTYPES[cfg.dtype]
    nh, ch = s.n_heads(d), s.d_inner(d) + 2 * s.d_state
    L = cfg.n_layers
    cache = {"state": torch.zeros((L, batch, nh, s.d_state, s.head_dim),
                                  dtype=torch.float32, device=device),
             "conv": torch.zeros((L, batch, s.d_conv - 1, ch), dtype=dt,
                                 device=device)}
    if cfg.arch_type == "hybrid":
        if seq_len % shards:
            raise ValueError(f"{seq_len} cache slots do not shard over "
                             f"{shards} ranks")
        a = cfg.attn
        shape = (L // cfg.hybrid_period, batch, seq_len // shards,
                 a.n_kv_heads, a.head_dim)
        cache["shared_k"] = torch.zeros(shape, dtype=dt, device=device)
        cache["shared_v"] = torch.zeros(shape, dtype=dt, device=device)
    return cache


def input_specs(cfg: ModelConfig, shape: ShapeSpec, par: ParallelConfig,
                mesh, device="meta") -> dict:
    """One rank's inputs of a step of ``shape.kind`` on ``mesh``, as empty
    tensors on ``device`` (no data is made): the port's counterpart of the
    reference's ``input_specs`` / ``cache_specs``, at the shapes the port's
    entry points take on this rank.

    * ``train``: :class:`SyntheticTokens`' shard — ``tokens`` / ``labels``
      (B_loc, T_loc) int32 (a VLM's text columns of the shard, with its
      ``image_embeds`` rows; an encoder–decoder's ``frames`` (B_loc, F,
      d_model) whole; ``segment_ids`` when ``shape.docs > 1``).
    * ``prefill``: the global prompt ``tokens`` (B, T) (a VLM's ``image
      _embeds`` (B, n, d_model) and T − n tokens; an encoder–decoder's
      ``frames`` (B, F, d_model)): ``DecoderLM.prefill`` takes the same
      prompt on every rank and keeps its own rows and positions.
    * ``decode``: ``token`` (B, 1) and ``pos`` (B,) int32, global as
      ``decode`` takes them, and ``cache``, this rank's shard: its data
      replica's rows, ``shape.seq_len / n`` slots of the sequence axes'
      ``n`` ranks — dense ``{"k", "v"}`` (L, B_loc, S_loc, H_kv, head_dim)
      or an MLA model's ``{"ckv"}`` (L, B_loc, S_loc, kv_lora + rope),
      :func:`empty_decode_cache`'s for the SSM families and
      :func:`audio_cache_shapes`' for the encoder–decoder."""
    from repro_torch.models.transformer import DTYPES
    B, T = shape.global_batch, shape.seq_len
    dt, i32 = DTYPES[cfg.dtype], torch.int32
    d = cfg.d_model

    def empty(*dims, dtype=i32):
        return torch.empty(dims, dtype=dtype, device=device)

    bg = batch_group(mesh, par)
    b_loc = B // (1 if bg is None else bg.size)
    if shape.kind == "train":
        rows, cols = SyntheticTokens(cfg, shape, device=device, mesh=mesh,
                                     par=par)._shard(B, T)
        if cfg.arch_type == "vlm":
            n = int((cols < cfg.n_image_tokens).sum())
            t = len(cols) - n
            return {"tokens": empty(b_loc, t), "labels": empty(b_loc, t),
                    "image_embeds": empty(b_loc, n, d, dtype=dt)}
        batch = {"tokens": empty(b_loc, len(cols)),
                 "labels": empty(b_loc, len(cols))}
        if cfg.arch_type == "audio":
            batch["frames"] = empty(b_loc, cfg.n_audio_frames, d, dtype=dt)
        elif shape.docs > 1:
            batch["segment_ids"] = empty(b_loc, len(cols))
        return batch
    if shape.kind == "prefill":
        if cfg.arch_type == "vlm":
            n = cfg.n_image_tokens
            return {"tokens": empty(B, T - n),
                    "image_embeds": empty(B, n, d, dtype=dt)}
        batch = {"tokens": empty(B, T)}
        if cfg.arch_type == "audio":
            batch["frames"] = empty(B, cfg.n_audio_frames, d, dtype=dt)
        return batch
    if shape.kind != "decode":
        raise ValueError(f"unknown step kind {shape.kind!r}")
    n = 1 if mesh is None else mesh.comm(
        tuple(a for a in mesh.axis_names if a in par.seq_axes)).size
    if T % n:
        raise ValueError(f"{T} cache slots do not shard over {n} ranks")
    a = cfg.attn
    if cfg.ssm is not None:
        cache = empty_decode_cache(cfg, b_loc, T, device=device, shards=n)
    elif cfg.arch_type == "audio":
        cache = {k: empty(*s, dtype=t) for k, (s, t) in
                 audio_cache_shapes(cfg, b_loc, T, n).items()}
    elif a.is_mla:
        cache = {"ckv": empty(cfg.n_layers, b_loc, T // n,
                              a.kv_lora_rank + a.qk_rope_head_dim,
                              dtype=dt)}
    else:
        kv = (cfg.n_layers, b_loc, T // n, a.n_kv_heads, a.head_dim)
        cache = {"k": empty(*kv, dtype=dt), "v": empty(*kv, dtype=dt)}
    return {"token": empty(B, 1), "pos": empty(B), "cache": cache}

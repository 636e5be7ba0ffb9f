"""Synthetic training data (port of the reference ``data/pipeline.py``:
``SyntheticTokens`` for dense, MoE, SSM and hybrid decoders) and the empty
decode cache of an SSM or hybrid model (:func:`empty_decode_cache`, the
reference's ``cache_specs`` arms for them).

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
sharding, so a shard's last label is the next shard's first token.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.config import ModelConfig, ParallelConfig, ShapeSpec
from repro_torch.core.dist_attention import shard_positions
from repro_torch.core.mask import doc_boundaries, segments_from_boundaries
from repro_torch.parallel.sharding import seq_group


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

    def batch(self, step: int) -> dict:
        if self.cfg.arch_type not in ("dense", "moe", "ssm", "hybrid"):
            raise ValueError(f"the port's pipeline feeds dense, MoE, SSM "
                             f"and hybrid decoders, not "
                             f"{self.cfg.arch_type!r}")
        B, T = self.shape.global_batch, self.shape.seq_len

        rows, cols = self._shard(B, T)

        def t(x):
            return torch.from_numpy(np.ascontiguousarray(
                x[rows][:, cols])).to(self.device)

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
        if "data" in par.batch_axes:
            D, d = self.mesh.size("data"), self.mesh.coord("data")
            rows = slice(d * B // D, (d + 1) * B // D)
        g = seq_group(self.mesh, par)
        cols = shard_positions(T, g.size, g.rank,
                               zigzag_layout(self.cfg, par, g.size))
        return rows, cols


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

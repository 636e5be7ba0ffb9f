"""Synthetic training data (port of the reference ``data/pipeline.py``,
``SyntheticTokens``, for dense decoders).

The tokens are the reference's, bit for bit: the same numpy generator, seed
and step give the same hash-mixed Markov stream, and with ``shape.docs > 1``
the same packed layout (``mask.doc_boundaries``), ``segment_ids`` and
``-100`` labels at each document's last token.  They are returned as int32
torch tensors on an explicit device.

On a process-group mesh each rank gets its (data, seq) shard of the same
global batch: rows by its ``data`` coordinate (when the batch shards over
``data``), columns by the global positions it holds (contiguous, or the
zigzag layout under the zigzag schedule).  Labels are shifted before
sharding, so a shard's last label is the next shard's first token.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.config import ModelConfig, ParallelConfig, ShapeSpec
from repro_torch.core.dist_attention import shard_positions
from repro_torch.core.mask import doc_boundaries, segments_from_boundaries


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
        if self.cfg.arch_type != "dense":
            raise ValueError(f"the port's pipeline feeds dense decoders, not "
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
        P = self.mesh.size(par.seq_axis)
        cols = shard_positions(T, P, self.mesh.coord(par.seq_axis),
                               zigzag_layout(self.cfg, par, P))
        return rows, cols

"""Synthetic training data (port of the reference ``data/pipeline.py``,
``SyntheticTokens``, for dense decoders).

The tokens are the reference's, bit for bit: the same numpy generator, seed
and step give the same hash-mixed Markov stream, and with ``shape.docs > 1``
the same packed layout (``mask.doc_boundaries``), ``segment_ids`` and
``-100`` labels at each document's last token.  They are returned as int32
torch tensors on an explicit device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.config import ModelConfig, ShapeSpec
from repro_torch.core.mask import doc_boundaries, segments_from_boundaries


@dataclasses.dataclass
class SyntheticTokens:
    """Reproducible pseudo-text: a Markov chain over the vocabulary that is
    learnable and fully determined by (seed, step).  When ``shape.docs >
    1`` each sequence packs ``docs`` independent documents and the batch
    gains ``segment_ids``."""
    cfg: ModelConfig
    shape: ShapeSpec
    device: str = "cuda"
    seed: int = 0

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

        def t(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

        if self.shape.kind == "train" and self.shape.docs > 1:
            tokens, labels, seg = self._packed(step, B, T)
            return {"tokens": t(tokens), "labels": t(labels),
                    "segment_ids": t(seg)}
        x = self._tokens(step, B, T)
        return {"tokens": t(x[:, :-1]), "labels": t(x[:, 1:])}

"""Model and shape configuration (port of the reference ``core/config.py``).

Configs are plain frozen dataclasses, so they hash and print cleanly.  The
fields are the reference's fields for a dense / GQA decoder, so a reference
config and its port describe the same model; the MLA, MoE, SSM, hybrid and
encoder fields arrive with the slices that serve those models.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class AttnConfig:
    """Attention-block configuration (dense multi-head / GQA)."""
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10_000.0
    window: int = 0                  # 0 => full causal attention


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                   # "dense" is the one the port serves
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    attn: Optional[AttnConfig] = None
    tie_embeddings: bool = True
    norm_eps: float = 1e-5
    citation: str = ""
    dtype: str = "bfloat16"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Parameter count of a dense / GQA decoder."""
        a, d = self.attn, self.d_model
        attn = d * (a.n_heads * a.head_dim + 2 * a.n_kv_heads * a.head_dim) \
            + a.n_heads * a.head_dim * d
        n = self.vocab * d * (1 if self.tie_embeddings else 2)
        return n + self.n_layers * (attn + 3 * d * self.d_ff)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"
    docs: int = 1


SHAPES = {
    "train_4k":    ShapeSpec("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeSpec("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeSpec("long_500k",   524_288, 1,   "decode"),
}


def get_config(arch: str) -> ModelConfig:
    """Load ``repro_torch/configs/<arch>.py`` and return its CONFIG."""
    mod = importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG


def get_shape(name: str) -> ShapeSpec:
    return SHAPES[name]


@dataclass(frozen=True)
class ParallelConfig:
    """How the mesh axes are used for a run (the reference's fields and
    defaults, without the 2D ``extra_seq_axes`` / ``head_axis``).

    ``batch_axes`` shard the batch; ``seq_axis`` is the sequence-parallel
    axis whose ranks run the distributed attention ``schedule`` (auto |
    balanced | ring | rsa | ulysses | zigzag, ``core/dist_attention``);
    ``fsdp_axes`` name the reference's parameter-sharding axes (the port
    replicates parameters and sums their gradients over the ranks that
    hold distinct tokens); ``remat`` is the checkpoint policy."""
    batch_axes: Tuple[str, ...] = ("data",)
    seq_axis: str = "model"
    fsdp_axes: Tuple[str, ...] = ("data",)
    schedule: str = "balanced"
    remat: str = "remat_aware"      # remat_aware | hf | none


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    warmup_steps: int = 100
    total_steps: int = 1000
    max_grad_norm: float = 1.0
    seed: int = 0


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced variant of the same family for CPU tests: 2 layers, 4 heads
    of 32, f32 — the reference's ``smoke_config`` for dense decoders."""
    kw = dict(n_layers=2, vocab=512, dtype="float32")
    if cfg.attn is not None:
        a = cfg.attn
        g = max(1, a.n_heads // max(a.n_kv_heads, 1))
        n_heads = 4
        kw["attn"] = dataclasses.replace(
            a, n_heads=n_heads, n_kv_heads=max(1, n_heads // g), head_dim=32)
        kw["d_model"] = n_heads * 32
        kw["d_ff"] = 256
    return dataclasses.replace(cfg, **kw)

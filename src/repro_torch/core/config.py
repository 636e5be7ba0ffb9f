"""Model and shape configuration (port of the reference ``core/config.py``).

Configs are plain frozen dataclasses, so they hash and print cleanly.  The
fields are the reference's fields for a dense / GQA decoder (with the Qwen
family's ``qkv_bias`` and ``qk_norm``) and for DeepSeek's multi-head latent
attention (MLA) and mixture-of-experts FFN (:class:`MoEConfig`), and for
the Mamba2 SSM and Zamba2 hybrid families (:class:`SSMConfig`,
``hybrid_period``), the InternVL2 vision-language model's stub image
tokens (``n_image_tokens``) and the Whisper encoder–decoder's encoder
layers and frame count (``n_enc_layers``, ``n_audio_frames``) and
DeepSeek-V3's multi-token prediction depth (``mtp_depth``), so a
reference config and its port describe the same model.  ``ARCH_IDS`` and
``PAPER_ARCH_IDS`` are the reference's lists: every entry has a config
under ``repro_torch/configs``.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class AttnConfig:
    """Attention-block configuration (dense multi-head / GQA / MLA)."""
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False           # Qwen2-style bias on q,k,v projections
    qk_norm: bool = False            # Qwen3-style RMSNorm on q,k heads
    rope_theta: float = 10_000.0
    # --- MLA (DeepSeek multi-head latent attention) ---
    kv_lora_rank: int = 0            # 0 => standard GQA path
    q_lora_rank: int = 0
    qk_rope_head_dim: int = 0        # decoupled rope key dim (MLA only)
    v_head_dim: int = 0              # MLA value head dim (defaults head_dim)
    window: int = 0                  # 0 => full causal attention

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def qk_nope_head_dim(self) -> int:
        return self.head_dim         # MLA: the non-rope part of a q/k head


@dataclass(frozen=True)
class MoEConfig:
    n_routed: int                    # routed experts
    n_shared: int                    # shared (always-on) experts
    top_k: int
    d_expert: int                    # per-expert FFN hidden size
    d_dense_ff: int                  # FFN size of the leading dense layers
    n_dense_layers: int = 1          # leading layers that use a dense FFN
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.001


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD, arXiv:2405.21060)."""
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128                 # SSD intra-chunk block length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                   # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    attn: Optional[AttnConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (Zamba2): a shared attention block every `hybrid_period` layers
    hybrid_period: int = 0
    # enc-dec (Whisper): encoder layers & fixed frame count (stub frontend)
    n_enc_layers: int = 0
    n_audio_frames: int = 0
    # VLM: number of stub patch-embedding tokens prepended to the text
    n_image_tokens: int = 0
    # DeepSeek-V3 multi-token prediction depth (extra MTP modules)
    mtp_depth: int = 0
    tie_embeddings: bool = True
    norm_eps: float = 1e-5
    citation: str = ""
    dtype: str = "bfloat16"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def uses_attention(self) -> bool:
        return self.arch_type != "ssm"

    def param_count(self) -> int:
        """Parameter count N, the reference's (norms, the q/k/v biases and
        qk-norm weights, the SSM's A_log / D / dt_bias and conv bias are not
        counted)."""
        return _param_count(self)

    def active_param_count(self) -> int:
        """Parameters a token passes through (MoE: the shared and top-k
        routed experts)."""
        return _param_count(self, active_only=True)


def _attn_params(c: ModelConfig) -> int:
    a, d = c.attn, c.d_model
    if a.is_mla:
        vh = a.v_head_dim or a.head_dim
        qk = a.qk_nope_head_dim + a.qk_rope_head_dim
        q_in = (d * a.q_lora_rank + a.q_lora_rank * a.n_heads * qk
                if a.q_lora_rank else d * a.n_heads * qk)
        kv_in = d * (a.kv_lora_rank + a.qk_rope_head_dim)
        kv_up = a.kv_lora_rank * a.n_heads * (a.qk_nope_head_dim + vh)
        return q_in + kv_in + kv_up + a.n_heads * vh * d
    hd = a.head_dim
    return d * (a.n_heads * hd + 2 * a.n_kv_heads * hd) + a.n_heads * hd * d


def _ssm_params(c: ModelConfig) -> int:
    """One Mamba2 mixer: in_proj to [z, x, B, C, dt], out_proj, the conv."""
    s = c.ssm
    di, nh = s.d_inner(c.d_model), s.n_heads(c.d_model)
    zxbcdt = 2 * di + 2 * s.d_state + nh
    return (c.d_model * zxbcdt + di * c.d_model
            + s.d_conv * (di + 2 * s.d_state))


def _param_count(c: ModelConfig, active_only: bool = False) -> int:
    """The reference's ``_param_count`` for dense, MoE, SSM, hybrid and VLM
    decoders (a hybrid's one shared block: attention and SwiGLU at
    2·d_model, and its down projection) and the encoder–decoder (its
    encoder layers, and a cross-attention block a decoder layer)."""
    d = c.d_model
    n = c.vocab * d * (1 if c.tie_embeddings else 2)
    if c.arch_type in ("ssm", "hybrid"):
        n += c.n_layers * _ssm_params(c)
        if c.arch_type == "ssm":
            return n
        a, d2 = c.attn, 2 * d
        hd = a.n_heads * a.head_dim
        return n + d2 * 3 * hd + hd * d2 + 3 * d2 * c.d_ff + d2 * d
    attn = _attn_params(c)
    if c.moe is None:
        n += (c.n_layers + c.n_enc_layers) * (attn + 3 * d * c.d_ff)
        return n + (c.n_layers * attn if c.n_enc_layers else 0)
    m = c.moe
    expert = 3 * d * m.d_expert
    routed = (m.top_k if active_only else m.n_routed) * expert
    n += c.n_layers * attn + m.n_dense_layers * 3 * d * m.d_dense_ff
    return n + (c.n_layers - m.n_dense_layers) * (
        m.n_shared * expert + d * m.n_routed + routed)


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


ARCH_IDS = (
    "smollm-360m", "mamba2-2.7b", "qwen2.5-14b", "qwen3-8b", "internvl2-2b",
    "deepseek-v2-lite-16b", "whisper-tiny", "deepseek-v3-671b",
    "qwen1.5-32b", "zamba2-2.7b",
)

# the paper's own evaluation models (§4: LLaMA-7B and variants)
PAPER_ARCH_IDS = ("llama-7b", "llama-gqa", "llama-33h", "llama-16h")


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
    defaults).

    ``batch_axes`` shard the batch; ``seq_axis`` is the sequence-parallel
    axis whose ranks run the distributed attention ``schedule`` (auto |
    balanced | ring | rsa | ulysses | zigzag, ``core/dist_attention``);
    ``head_axis`` names the head sub-axis of a factored 2D (seq × head)
    mesh (``launch.mesh.make_seq2d_mesh``): activations then shard the
    sequence over the (``seq_axis``, ``head_axis``) pair, head minor, and
    attention runs the 2D plans (``core/schedule.Plan2D``);
    ``extra_seq_axes`` are axes folded into the sequence sharding of a
    decode cache (``long_500k``: batch 1 leaves ``data`` idle);
    ``fsdp_axes`` are the parameter-sharding axes (``pod`` and ``data``):
    a model built with ``fsdp=True`` holds only its shard of each
    parameter and AdamW moment (ZeRO-3, ``parallel/fsdp.py``, the
    reference's ``param_spec`` rule), gathers each weight on use and
    reduce-scatters its gradient over them; an MoE model's routed experts
    also shard their rows over ``seq_axis``; ``remat`` is the checkpoint
    policy."""
    batch_axes: Tuple[str, ...] = ("data",)
    seq_axis: str = "model"
    extra_seq_axes: Tuple[str, ...] = ()
    fsdp_axes: Tuple[str, ...] = ("data",)
    schedule: str = "balanced"
    remat: str = "remat_aware"      # remat_aware | hf | none
    head_axis: Optional[str] = None

    @property
    def seq_axes(self) -> Tuple[str, ...]:
        """Every axis the sequence dim shards over, the minor-most last
        (``extra_seq_axes``, ``seq_axis``, then the 2D ``head_axis``)."""
        axes = tuple(self.extra_seq_axes) + (self.seq_axis,)
        if self.head_axis is not None:
            axes += (self.head_axis,)
        return axes


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
    of 32, f32, MLA ranks 32 / rope 16 / v 32, 4 routed experts (top 2,
    capacity 4.0); an SSM of d_model 64, d_state 16, head dim 8, chunk 16;
    a hybrid of d_model 64, d_ff 128, 4 heads of 32 (4·32 = 2·64) and a
    shared block every layer; 2 encoder layers and 64 frames; 16 image
    tokens — the reference's ``smoke_config``."""
    kw = dict(n_layers=2, vocab=512, dtype="float32")
    if cfg.attn is not None:
        a = cfg.attn
        g = max(1, a.n_heads // max(a.n_kv_heads, 1))
        n_heads = 4
        kw["attn"] = dataclasses.replace(
            a, n_heads=n_heads, n_kv_heads=max(1, n_heads // g), head_dim=32,
            kv_lora_rank=32 if a.kv_lora_rank else 0,
            q_lora_rank=32 if a.q_lora_rank else 0,
            qk_rope_head_dim=16 if a.qk_rope_head_dim else 0,
            v_head_dim=32 if a.v_head_dim else 0)
        kw["d_model"] = n_heads * 32
        kw["d_ff"] = 256
    if cfg.arch_type == "hybrid":
        kw["d_model"] = 64
        kw["attn"] = dataclasses.replace(kw["attn"], head_dim=32,
                                         n_kv_heads=4)  # 4·32 == 2·64
        kw["hybrid_period"] = 1
        kw["d_ff"] = 128
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=8,
                                        chunk=16)
        if cfg.arch_type == "ssm":
            kw["d_model"] = 64
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_routed=4, n_shared=min(cfg.moe.n_shared, 1),
            top_k=2, d_expert=64, d_dense_ff=128, n_dense_layers=1,
            capacity_factor=4.0)
    if cfg.n_enc_layers:
        kw["n_enc_layers"] = 2
        kw["n_audio_frames"] = 64
    if cfg.n_image_tokens:
        kw["n_image_tokens"] = 16
    return dataclasses.replace(cfg, **kw)

"""Qwen2.5-14B — dense GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B]."""
from repro_torch.core.config import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", arch_type="dense",
    n_layers=48, d_model=5120, d_ff=13824, vocab=152064,
    attn=AttnConfig(n_heads=40, n_kv_heads=8, head_dim=128, qkv_bias=True,
                    rope_theta=1e6),
    tie_embeddings=False,
    citation="hf:Qwen/Qwen2.5-0.5B",
)

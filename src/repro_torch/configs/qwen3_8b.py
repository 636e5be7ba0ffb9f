"""Qwen3-8B — dense GQA with qk_norm [hf:Qwen/Qwen3-8B]."""
from repro_torch.core.config import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", arch_type="dense",
    n_layers=36, d_model=4096, d_ff=12288, vocab=151936,
    attn=AttnConfig(n_heads=32, n_kv_heads=8, head_dim=128, qk_norm=True,
                    rope_theta=1e6),
    tie_embeddings=False,
    citation="hf:Qwen/Qwen3-8B",
)

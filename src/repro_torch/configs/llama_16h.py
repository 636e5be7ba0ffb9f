"""LLaMA-16H — fewer-heads variant: 16 heads, d=2048, 64 layers (paper §4.2)."""
from repro_torch.core.config import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama-16h", arch_type="dense",
    n_layers=64, d_model=2048, d_ff=11008, vocab=32000,
    attn=AttnConfig(n_heads=16, n_kv_heads=16, head_dim=128),
    tie_embeddings=False,
    citation="paper §4.2 / Liu et al. 2021",
)

"""LLaMA-33H — LLaMA-7B with 33 heads (irregular head count, paper §4.2):
head-parallel attention (``ulysses``) cannot split it over 2, 4 or 8
ranks."""
from repro_torch.core.config import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama-33h", arch_type="dense",
    n_layers=32, d_model=4096, d_ff=11008, vocab=32000,
    attn=AttnConfig(n_heads=33, n_kv_heads=33, head_dim=128),
    tie_embeddings=False,
    citation="paper §4.2",
)

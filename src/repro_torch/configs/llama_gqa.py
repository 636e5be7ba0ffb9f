"""LLaMA-GQA — LLaMA-7B with 8 kv heads (paper §4, Table 1)."""
from repro_torch.core.config import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama-gqa", arch_type="dense",
    n_layers=32, d_model=4096, d_ff=11008, vocab=32000,
    attn=AttnConfig(n_heads=32, n_kv_heads=8, head_dim=128),
    tie_embeddings=False,
    citation="paper §4 / arXiv:2305.13245",
)

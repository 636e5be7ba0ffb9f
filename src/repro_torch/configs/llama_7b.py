"""LLaMA-7B — the paper's primary evaluation model (§4, Table 1)."""
from repro_torch.core.config import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama-7b", arch_type="dense",
    n_layers=32, d_model=4096, d_ff=11008, vocab=32000,
    attn=AttnConfig(n_heads=32, n_kv_heads=32, head_dim=128),
    tie_embeddings=False,
    citation="arXiv:2302.13971 (paper §4)",
)

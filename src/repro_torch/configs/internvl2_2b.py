"""InternVL2-2B — InternViT (stub frontend) + InternLM2-1.8B decoder
[arXiv:2404.16821]: 256 precomputed patch embeddings are prepended to the
text."""
from repro_torch.core.config import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", arch_type="vlm",
    n_layers=24, d_model=2048, d_ff=8192, vocab=92553,
    attn=AttnConfig(n_heads=16, n_kv_heads=8, head_dim=128),
    n_image_tokens=256,
    citation="arXiv:2404.16821",
)

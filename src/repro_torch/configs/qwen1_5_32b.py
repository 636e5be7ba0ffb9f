"""Qwen1.5-32B — dense MHA-ish (kv=40) with QKV bias [hf:Qwen/Qwen1.5-0.5B]."""
from repro_torch.core.config import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", arch_type="dense",
    n_layers=64, d_model=5120, d_ff=27392, vocab=152064,
    attn=AttnConfig(n_heads=40, n_kv_heads=40, head_dim=128, qkv_bias=True),
    tie_embeddings=False,
    citation="hf:Qwen/Qwen1.5-0.5B",
)

"""Zamba2-2.7B — Mamba2 backbone + shared attention block every 6 layers,
operating on concat(h, embed) = 2·d_model [arXiv:2411.15242]."""
from repro_torch.core.config import AttnConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", arch_type="hybrid",
    n_layers=54, d_model=2560, d_ff=10240, vocab=32000,
    attn=AttnConfig(n_heads=32, n_kv_heads=32, head_dim=160),  # 32·160 = 2·d
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=128),
    hybrid_period=6,
    citation="arXiv:2411.15242",
)

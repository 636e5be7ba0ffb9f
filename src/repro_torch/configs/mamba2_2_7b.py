"""Mamba2-2.7B — SSD (state-space duality), attention-free [arXiv:2405.21060]."""
from repro_torch.core.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", arch_type="ssm",
    n_layers=64, d_model=2560, d_ff=0, vocab=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=128),
    citation="arXiv:2405.21060",
)

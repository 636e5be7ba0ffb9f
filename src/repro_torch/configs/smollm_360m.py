"""SmolLM-360M — llama-arch small dense LM [hf:HuggingFaceTB/SmolLM-135M];
the draft paired with the llama family (``configs/spec_pairs.py``)."""
from repro_torch.core.config import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", arch_type="dense",
    n_layers=32, d_model=960, d_ff=2560, vocab=49152,
    attn=AttnConfig(n_heads=15, n_kv_heads=5, head_dim=64),
    citation="hf:HuggingFaceTB/SmolLM-135M",
)

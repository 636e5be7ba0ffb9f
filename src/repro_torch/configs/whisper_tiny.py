"""Whisper-tiny — encoder-decoder audio backbone; the mel/conv frontend is
a stub (1500 precomputed frame embeddings, padded to 1536)
[arXiv:2212.04356]."""
from repro_torch.core.config import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", arch_type="audio",
    n_layers=4, n_enc_layers=4, d_model=384, d_ff=1536, vocab=51865,
    attn=AttnConfig(n_heads=6, n_kv_heads=6, head_dim=64),
    n_audio_frames=1536,
    citation="arXiv:2212.04356",
)

"""DeepSeek-V2-Lite (16B) — MLA (kv_lora=512) + MoE [arXiv:2405.04434].

The reference's note: the assignment's pool line says both "MoE 64e top-6"
and "160 routed"; the real V2-Lite has 64 routed experts (V2 has 160).  The
primary spec is followed: 64 routed + 2 shared, top-6."""
from repro_torch.core.config import AttnConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", arch_type="moe",
    n_layers=27, d_model=2048, d_ff=0, vocab=102400,
    attn=AttnConfig(n_heads=16, n_kv_heads=16, head_dim=128,
                    kv_lora_rank=512, q_lora_rank=0, qk_rope_head_dim=64,
                    v_head_dim=128),
    moe=MoEConfig(n_routed=64, n_shared=2, top_k=6, d_expert=1408,
                  d_dense_ff=10944, n_dense_layers=1),
    citation="arXiv:2405.04434",
)

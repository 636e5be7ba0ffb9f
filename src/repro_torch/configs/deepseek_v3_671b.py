"""DeepSeek-V3 (671B) — MLA + 256-expert MoE + multi-token prediction
[arXiv:2412.19437].

The reference's values.  Its router is the reference's (softmax over the
routed experts, then top-k), not DeepSeek-V3's sigmoid scores with a
load-balancing bias; its one MTP block (``mtp_depth=1``) predicts token
t + 2 and is not counted by ``param_count``, as in the reference."""
from repro_torch.core.config import AttnConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", arch_type="moe",
    n_layers=61, d_model=7168, d_ff=0, vocab=129280,
    attn=AttnConfig(n_heads=128, n_kv_heads=128, head_dim=128,
                    kv_lora_rank=512, q_lora_rank=1536, qk_rope_head_dim=64,
                    v_head_dim=128),
    moe=MoEConfig(n_routed=256, n_shared=1, top_k=8, d_expert=2048,
                  d_dense_ff=18432, n_dense_layers=3),
    mtp_depth=1,
    citation="arXiv:2412.19437",
)

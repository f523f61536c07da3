"""DeepSeek-V2 236B — MLA (kv_lora=512) + 160-expert top-6 MoE with 2 shared
experts; first layer dense [arXiv:2405.04434; hf]."""
from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=12288,  # dense-MLP width for the first (non-MoE) layer
    vocab_size=102400,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=160, top_k=6, d_ff_expert=1536, num_shared=2,
                  first_dense_layers=1, capacity_factor=1.25),
    source="arXiv:2405.04434; hf",
)

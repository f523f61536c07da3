"""Jamba-1.5-Large 398B — hybrid Mamba+attention 1:7 interleave, 16-expert
top-2 MoE every other layer [arXiv:2403.19887; hf].

72 layers = 9 periods of 8 (attention at position 4 of each period, Mamba
elsewhere); MoE replaces the MLP on every second layer.
"""
from .base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    hybrid_pattern=("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba"),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576, every_k_layers=2),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=128, n_groups=1, chunk=256),
    source="arXiv:2403.19887; hf",
)

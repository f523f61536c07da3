"""Mixtral-8x22B — 8-expert top-2 MoE, GQA kv=8, sliding-window attention
[arXiv:2401.04088; hf]."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    sliding_window=4096,
    layer_pattern=("local",),  # every layer sliding-window (assignment: SWA)
    rope_theta=1000000.0,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=16384),
    source="arXiv:2401.04088; hf",
)

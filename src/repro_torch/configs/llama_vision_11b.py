"""Llama-3.2-Vision-11B transformer backbone [hf:meta-llama/Llama-3.2-11B-Vision].

Cross-attention image layers every 5th layer (8 of 40); the vision tower is
a stub per the assignment — ``input_specs()`` supplies precomputed patch
embeddings already projected to d_model.
"""
from .base import CrossAttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500000.0,
    cross_attn=CrossAttnConfig(every_k_layers=5, source_len=1600, source_dim=4096),
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)

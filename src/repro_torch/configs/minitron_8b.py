"""Minitron-8B — width-pruned Nemotron-4 [arXiv:2407.14679; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    source="arXiv:2407.14679; hf",
)

"""Gemma-3 12B — 5:1 local:global, 1024 window, 262144 vocab, tied
[hf:google/gemma-3-1b-pt pattern; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    sliding_window=1024,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    rope_theta=1000000.0,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt; unverified",
)

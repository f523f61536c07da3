"""Gemma-3 27B — 5:1 local:global attention, 1024-token window, 128k context,
262144 vocab, tied embeddings [hf:google/gemma-3-1b-pt pattern; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    sliding_window=1024,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    rope_theta=1000000.0,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt; unverified",
)

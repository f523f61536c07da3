"""SmolLM-360M — llama-arch small model; the correctness-workhorse config
[hf:HuggingFaceTB/SmolLM-135M; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M; hf",
)

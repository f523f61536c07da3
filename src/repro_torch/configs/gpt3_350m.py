"""GPT-3 medium (350M) — the paper's own correctness-evaluation model
(Table 4: L=24, H=1024, A=16). Rotary embeddings replace learned positions
(noted in DESIGN.md; irrelevant to checkpoint semantics)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gpt3-350m",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51200,
    source="paper Table 4 [Brown et al. 2020]",
)

"""Whisper-tiny backbone — 4L enc + 4L dec, d=384, 6 heads
[arXiv:2212.04356]. The conv audio frontend is a stub: input_specs()
provides 1500 precomputed frame embeddings."""
from .base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    num_layers=4,       # decoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    encoder=EncoderConfig(num_layers=4, source_len=1500),
    source="arXiv:2212.04356; unverified",
)

"""Mamba2-130M — attention-free SSD (state-space duality) [arXiv:2405.21060]."""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=1,       # unused (attention-free)
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,            # no MLP: Mamba2 block subsumes it
    vocab_size=50280,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=256),
    source="arXiv:2405.21060; unverified",
)

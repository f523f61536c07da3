"""Flash-attention forward: CUDA kernel for sm_90a, its wrapper and its plain version."""

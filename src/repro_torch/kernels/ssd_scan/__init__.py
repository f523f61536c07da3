"""Mamba-2 SSD chunk scan: CUDA kernel for sm_90a, its wrapper and its plain version."""

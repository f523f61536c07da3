"""Block quantize and dequantize: CUDA kernels for sm_90a, their wrappers
and their plain version — the core of the shard codec."""

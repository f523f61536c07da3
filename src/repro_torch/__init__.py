"""PyTorch/CUDA port of the Universal Checkpointing reproduction.

A second package beside ``repro`` (the JAX reference), file for file:
``repro_torch/core/layout.py`` is held against ``repro/core/layout.py``.
It imports ``torch`` and ``numpy`` and nothing of ``repro``; checkpoints
interchange with the reference bit for bit.
"""

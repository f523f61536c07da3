"""Public wrappers of the block-quant kernels (port of
``repro/kernels/block_quant/ops.py``): the shared core of the shard codec.

* ``block_quantize(x, block=, dtype=)`` takes a tensor of any shape and
  returns ``(q [nblocks, block], scales [nblocks])``;
* ``block_dequantize(q, scales, count=)`` returns the flat fp32 of the
  first ``count`` elements.

On CUDA tensors they launch the Hopper kernels (``kernel.py``) or raise —
there is no fallback and no switch; on CPU tensors they compute the plain
version (``ref.py``).  ``block_quantize.launches`` and
``block_dequantize.launches`` count kernel launches (the plain version does
not count); ``launches_by_variant`` on each splits the same count by the
kernel that the row width and pointers picked (``kernel.variant``).
"""

from __future__ import annotations

import torch

from . import kernel
from .ref import blocked, dequantize_blocks, qdtype_name, quantize_blocks

__all__ = ["block_quantize", "block_dequantize"]


def block_quantize(
    x: torch.Tensor, *, block: int = 256, dtype="int8"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize any-shape ``x``; the element count is not recoverable from
    the output — the caller records it to dequantize."""
    name = qdtype_name(dtype)
    blocks = blocked(x, block=block)
    if x.device.type == "cpu":
        return quantize_blocks(blocks, dtype=name)
    if x.device.type == "cuda":
        q, scales, which = kernel.quantize_blocks(blocks.contiguous(), dtype=name)
        block_quantize.launches += 1
        block_quantize.launches_by_variant[which] += 1
        return q, scales
    raise ValueError(f"block_quantize: tensor on {x.device}; takes CPU or CUDA")


def block_dequantize(q: torch.Tensor, scales: torch.Tensor, *, count: int) -> torch.Tensor:
    """Dequantize → flat fp32 of the first ``count`` logical elements."""
    if q.device.type == "cpu" and scales.device.type == "cpu":
        return dequantize_blocks(q, scales, count=count)
    if q.device.type == "cuda":
        out, which = kernel.dequantize_blocks(q.contiguous(), scales.contiguous())
        block_dequantize.launches += 1
        block_dequantize.launches_by_variant[which] += 1
        return out.reshape(-1)[:count]
    raise ValueError(f"block_dequantize: q on {q.device}, scales on {scales.device}")


block_quantize.launches = 0
block_quantize.launches_by_variant = {"vector": 0, "general": 0}
block_dequantize.launches = 0
block_dequantize.launches_by_variant = {"vector": 0, "general": 0}

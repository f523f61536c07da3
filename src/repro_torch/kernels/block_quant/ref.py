"""The plain PyTorch version of block quantization, on any device
(port of ``repro/kernels/block_quant/ref.py``).

The format, identical for int8 and per-block-scaled fp8:

* the input is flattened C-order, cast to fp32 and zero-padded to a
  multiple of ``block`` (:func:`blocked`) — zero padding never changes a
  block's absmax;
* ``scales[i] = max(|block_i|) · fl32(1/fmax)``: the reference's codec runs
  its ``ref.quantize_blocks`` under ``jax.jit``, where XLA folds the
  division by the constant ``fmax`` into a multiply by its rounded
  reciprocal, so that is the scale its checkpoints hold (an eager,
  unjitted call divides and differs in the last bit of some scales);
* ``q = round(clip(block / safe, ±fmax))`` with ``safe = scale or 1``,
  rounding half to even for int8 and in the cast for fp8;
* dequantize is ``q·scale``, sliced to the explicit element ``count``.

NaN and inf follow the reference: a NaN makes its block's absmax and scale
NaN (``safe`` is then 1) and passes the clip, so it is stored as int8 0 or
an fp8 NaN code (e4m3 ``0x7f | sign``, e5m2 ``0x7e | sign``, the
reference's bytes); an inf makes the scale inf, so ``x / inf`` is ±0 and
``inf / inf`` NaN.  Either way the whole block decodes to NaN.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "FMAX",
    "QDTYPES",
    "blocked",
    "dequantize_blocks",
    "qdtype_name",
    "quantize_blocks",
    "reciprocal",
]

# Max representable magnitude per quantized dtype (the scale denominator).
FMAX = {
    "int8": 127.0,
    "float8_e4m3fn": 448.0,
    "float8_e5m2": 57344.0,
}
QDTYPES = {
    "int8": torch.int8,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}
_NAMES = {t: n for n, t in QDTYPES.items()}


def qdtype_name(dtype) -> str:
    """The format name of a quantized dtype given by name or torch dtype."""
    name = _NAMES.get(dtype, dtype)
    if name not in FMAX:
        raise ValueError(f"no block-quant format for {dtype!r} (takes {sorted(FMAX)})")
    return name


def reciprocal(name: str) -> float:
    """``fl32(1/fmax)``, the factor of every scale (exact as a Python float)."""
    return float(np.float32(1.0) / np.float32(FMAX[name]))


def blocked(x: torch.Tensor, *, block: int) -> torch.Tensor:
    """Flatten C-order, cast fp32, zero-pad, reshape to ``[nblocks, block]``."""
    flat = x.reshape(-1).to(torch.float32)
    n = flat.numel()
    nblocks = -(-n // block)
    if nblocks * block != n:
        flat = F.pad(flat, (0, nblocks * block - n))
    return flat.reshape(nblocks, block)


def quantize_blocks(blocks: torch.Tensor, *, dtype="int8") -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize pre-blocked fp32 ``[nblocks, block]`` → ``(q, scales)``."""
    name = qdtype_name(dtype)
    fmax = FMAX[name]
    scales = blocks.abs().amax(dim=1) * reciprocal(name)
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    y = (blocks / safe[:, None]).clamp(-fmax, fmax)
    if name == "int8":
        # half to even, as jnp.round; a NaN is stored as 0, as the
        # reference's cast does (a cast of NaN to int8 is the device's own)
        y = torch.round(y).nan_to_num(nan=0.0)
    q = y.to(QDTYPES[name])
    if name == "float8_e5m2":
        # The reference writes fp16's quiet NaN's high byte, 0x7e | sign;
        # PyTorch's cast writes 0x7f | sign.  Only the NaN codes change.
        b = q.view(torch.uint8)
        q = torch.where(torch.isnan(y), (b & 0x80) | 0x7E, b).view(q.dtype)
    return q, scales


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor, *, count: int) -> torch.Tensor:
    """Flat fp32 of the first ``count`` logical elements of ``(q, scales)``."""
    return (q.to(torch.float32) * scales[:, None]).reshape(-1)[:count]

"""The plain PyTorch version of the flash-attention kernel: a naive O(S²)
softmax, the counterpart of ``repro/kernels/flash_attention/ref.py::attention_ref``.

Kernel layout ``[B, H, S, D]``, as the reference's oracle; everything is
computed in float32 and the output is cast once to q's dtype.
"""

from __future__ import annotations

import math

import torch

__all__ = ["attention_ref"]


def attention_ref(
    q: torch.Tensor,  # [B, Hq, Sq, D]
    k: torch.Tensor,  # [B, Hkv, Skv, D]
    v: torch.Tensor,  # [B, Hkv, Skv, Dv]
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Row i of q sits at position ``q_offset + i`` in the masks."""
    _, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    diff = (
        q_offset + torch.arange(sq, device=q.device)[:, None]
        - torch.arange(skv, device=q.device)[None, :]
    )
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= diff >= 0
    if window > 0:
        mask &= diff < window
    s = torch.where(mask[None, None], s, -2.0e38)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)

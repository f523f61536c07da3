"""The plain O(S) recurrence in kernel layout, the counterpart of
``repro/kernels/ssd_scan/ref.py::ssd_ref``.

Kernel layout ``[B, H, S, ·]`` with groups already broadcast to heads, as
the reference's oracle.  It is :func:`repro_torch.models.ssm.ssd_recurrent`
(model layout) through transposes, so the port keeps one O(S) oracle.  The
chunked form the kernel computes is :func:`repro_torch.models.ssm.ssd_chunked`.
"""

from __future__ import annotations

import torch

from repro_torch.models.ssm import ssd_recurrent

__all__ = ["ssd_ref"]


def ssd_ref(
    x: torch.Tensor,   # [B, H, S, P]
    dt: torch.Tensor,  # [B, H, S]
    a: torch.Tensor,   # [H] (negative)
    b: torch.Tensor,   # [B, H, S, N]
    c: torch.Tensor,   # [B, H, S, N]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_tᵀ;  y_t = C_t·h_t.
    Returns (y [B,H,S,P] in x's dtype, h_final [B,H,P,N] float32)."""
    y, h_final = ssd_recurrent(*(t.transpose(1, 2) for t in (x, dt)), a,
                               *(t.transpose(1, 2) for t in (b, c)))
    return y.transpose(1, 2), h_final

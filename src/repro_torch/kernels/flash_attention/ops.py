"""Public wrapper of the flash-attention kernel, in model layout
(port of ``repro/kernels/flash_attention/ops.py``).

``flash_attention(q, k, v)`` takes ``[B, S, H, D]`` tensors, v with its own
head dim ``Dv`` (MLA's 128 beside q's and k's 192), and returns
``[B, Sq, Hq, Dv]``; the default scale is ``1/sqrt(D)``, q's head dim, as
the reference's ``full_attention``, and row i of q sits at position
``q_offset + i`` in the causal and window masks, as in the reference's
``LM._attention`` (a rank's query rows under sequence parallelism attend
at their place in the whole sequence):

* on CUDA tensors it launches the Hopper kernel (``kernel.py``) or raises —
  there is no fallback and no switch.  The kernel has no backward (the JAX
  package has none either), so it refuses inputs for which autograd would
  record a gradient (:func:`repro_torch.kernels.records_grad`) instead of
  returning a detached output; the model takes its differentiable plain
  attention then;
* on CPU tensors it computes the plain version (``ref.attention_ref``),
  which is how the tests on a machine without a card reach the same math;
* on meta tensors (the dry run's stand-in for the card,
  ``repro_torch.launch.dryrun``) it is the kernel's shape function: the
  launch's shape and dtype checks (``kernel._check``; not the row
  alignment, which a meta tensor has not), an empty output of the kernel's
  shape and dtype, and one launch reported to the dry run's analyzer with
  the kernel's operations and bytes (:func:`launch_cost`).  Mixed devices
  are refused.

``flash_attention.launches`` counts kernel launches (a plain integer; the
plain version and the shape function do not count), so a run can show
that its path went through the kernel; ``flash_attention.launches_by_dtype``
splits the same count by the inputs' dtype, and
``flash_attention.launches_by_variant`` by the kernel it took
(``kernel.variant``: ``"wgmma"`` for bfloat16 at D >= 64, ``"mma"`` below,
``"fp32"`` for float32).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import records_grad, report_meta_launch

from . import kernel
from .ref import attention_ref

__all__ = ["flash_attention", "refuse_grad", "launch_cost", "attention_pairs"]


def refuse_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise when the kernel's output would silently cut the gradient."""
    if records_grad(q, k, v):
        raise RuntimeError(
            "flash_attention: the CUDA kernel has no backward and its output "
            "would carry no gradient; call it under torch.no_grad() or "
            "inference_mode, or use models.attention.full_attention for training"
        )


def attention_pairs(sq: int, skv: int, *, causal: bool, window: int, q_offset: int = 0) -> int:
    """The (query row, key column) pairs a head computes: row i, at position
    ``q_offset + i``, sees columns ``lo..hi-1`` (causal: at most its
    position, and none past ``skv``; a window of w: the last w).  Summed
    exactly over the piecewise-linear count, in time independent of ``sq``."""

    def count(p: int) -> int:
        lo = max(0, p - window + 1) if window > 0 else 0
        hi = min(p + 1, skv) if causal else skv
        return max(0, hi - lo)

    end = q_offset + sq
    cuts = {q_offset, end}
    for x in (skv, window, skv + window):  # where a term of the count bends
        cuts.update(c for c in (x - 2, x - 1, x, x + 1) if q_offset < c < end)
    edges = sorted(cuts)
    return sum((count(lo) + count(hi - 1)) * (hi - lo) // 2 for lo, hi in zip(edges, edges[1:]))


def launch_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, window: int,
                q_offset: int = 0) -> tuple[float, int]:
    """(operations, bytes) of one launch: 2·D FLOPs a pair for Q·Kᵀ and 2·Dv
    for P·V over the pairs the mask allows; q, k, v read and the output
    written once."""
    b, sq, hq, d = q.shape
    dv = v.shape[-1]
    pairs = attention_pairs(sq, k.shape[1], causal=causal, window=window, q_offset=q_offset)
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v))
    return 2.0 * (d + dv) * pairs * b * hq, nbytes + b * sq * hq * dv * q.element_size()


def flash_attention(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Skv, Hkv, D]
    v: torch.Tensor,  # [B, Skv, Hkv, Dv]
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    devices = {t.device.type for t in (q, k, v)}
    if devices == {"cpu"}:
        o = attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window, scale=scale, q_offset=q_offset,
        )
        return o.transpose(1, 2)
    if devices == {"cuda"}:
        refuse_grad(q, k, v)
        o = kernel.flash_attention_fwd(q, k, v, causal=causal, window=window, scale=scale,
                                       q_offset=q_offset)
        flash_attention.launches += 1
        flash_attention.launches_by_dtype[str(q.dtype).removeprefix("torch.")] += 1
        flash_attention.launches_by_variant[kernel.variant(q, v)] += 1
        return o
    if devices == {"meta"}:  # the shape function: the launch's contract, no launch
        refuse_grad(q, k, v)
        kernel._check(q, k, v, device="meta")
        if q_offset < 0:
            raise ValueError(f"flash_attention_fwd: q_offset {q_offset} < 0")
        flops, nbytes = launch_cost(q, k, v, causal=causal, window=window, q_offset=q_offset)
        b, sq, hq, d = q.shape
        shape = (f"{hq}:{k.shape[2]} heads of ({d}, {v.shape[3]}), {sq} x {k.shape[1]}"
                 f"{', causal' if causal else ''}{f', window {window}' if window else ''}")
        report_meta_launch("flash_attention_fwd", flops=flops, nbytes=nbytes, shape=shape)
        return torch.empty((*q.shape[:3], v.shape[3]), dtype=q.dtype, device="meta")
    raise ValueError(f"flash_attention: tensors on {sorted(devices)}; takes all-CPU or all-CUDA "
                     "(or all-meta: the shape function)")


flash_attention.launches = 0
flash_attention.launches_by_dtype = {"bfloat16": 0, "float32": 0}
flash_attention.launches_by_variant = {"wgmma": 0, "mma": 0, "fp32": 0}

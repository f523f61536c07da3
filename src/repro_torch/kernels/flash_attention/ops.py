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
  which is how the tests on a machine without a card reach the same math.

``flash_attention.launches`` counts kernel launches (a plain integer; the
plain version does not count), so a run can show that its path went
through the kernel; ``flash_attention.launches_by_dtype`` splits the same
count by the inputs' dtype, which picks the kernel (bfloat16: tensor
cores; float32: CUDA cores).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import records_grad

from . import kernel
from .ref import attention_ref

__all__ = ["flash_attention", "refuse_grad"]


def refuse_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise when the kernel's output would silently cut the gradient."""
    if records_grad(q, k, v):
        raise RuntimeError(
            "flash_attention: the CUDA kernel has no backward and its output "
            "would carry no gradient; call it under torch.no_grad() or "
            "inference_mode, or use models.attention.full_attention for training"
        )


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
        return o
    raise ValueError(f"flash_attention: tensors on {sorted(devices)}; takes all-CPU or all-CUDA")


flash_attention.launches = 0
flash_attention.launches_by_dtype = {"bfloat16": 0, "float32": 0}

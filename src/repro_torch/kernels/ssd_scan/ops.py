"""Public wrapper of the SSD chunk-scan kernel, in model layout (port of
``repro/kernels/ssd_scan/ops.py``).

``ssd_scan(x, dt, a, b, c, chunk=)`` takes x [B,S,H,P], dt [B,S,H], a [H],
b/c [B,S,G,N] and returns (y [B,S,H,P], h_final [B,H,P,N]), as the
reference's wrapper:

* on CUDA tensors it launches the Hopper kernel (``kernel.py``), which reads
  the groups through ``h // (H/G)`` with no repeat, or raises — there is no
  fallback and no switch.  The kernel has no backward (the JAX package has
  none either), so it refuses inputs for which autograd would record a
  gradient; the model takes its differentiable ``ssd_chunked`` then;
* on CPU tensors it computes the plain version of the function the kernel
  computes, :func:`repro_torch.models.ssm.ssd_chunked` at the same chunk
  (the card's check in ``chip_smoke.py`` holds the kernel against it too);
* on meta tensors (the dry run's stand-in for the card) it is the kernel's
  shape function: the launch's checks (``kernel._check``, less the row
  alignment), empty outputs of the kernel's shapes and dtypes, and one
  launch reported to the dry run's analyzer (:func:`launch_cost`).  Mixed
  devices are refused.

``ssd_scan.launches`` counts kernel launches (a plain integer; the plain
version and the shape function do not count); ``ssd_scan.launches_by_dtype``
splits the same count by x's dtype, which picks the kernel (bfloat16:
tensor cores; float32: CUDA cores).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import records_grad, report_meta_launch

from . import kernel

__all__ = ["ssd_scan", "refuse_grad", "launch_cost"]


def refuse_grad(*tensors: torch.Tensor) -> None:
    """Raise when the kernel's output would silently cut the gradient."""
    if records_grad(*tensors):
        raise RuntimeError(
            "ssd_scan: the CUDA kernel has no backward and its output would carry "
            "no gradient; call it under torch.no_grad() or inference_mode, or use "
            "models.ssm.ssd_chunked for training"
        )


def launch_cost(x, dt, a, b, c, *, chunk: int) -> tuple[float, int]:
    """(operations, bytes) of one launch: each chunk's C·Bᵀ and its product
    with dt·x over the causal triangle (j <= i), the inter-chunk term and the
    state update in full; x, dt, a, B and C read and y and h_final (fp32)
    written once."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    tri = chunk * (chunk + 1) // 2
    flops = float((2 * tri * n + 2 * tri * p + 4 * chunk * n * p) * bsz * h * (s // chunk))
    nbytes = sum(t.numel() * t.element_size() for t in (x, dt, a, b, c))
    return flops, nbytes + x.numel() * x.element_size() + bsz * h * p * n * 4


def ssd_scan(
    x: torch.Tensor,   # [B, S, H, P]  (model layout)
    dt: torch.Tensor,  # [B, S, H]
    a: torch.Tensor,   # [H]
    b: torch.Tensor,   # [B, S, G, N]
    c: torch.Tensor,   # [B, S, G, N]
    *,
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    s = x.shape[1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    devices = {t.device.type for t in (x, dt, a, b, c)}
    if devices == {"cpu"}:
        # imported here: repro_torch.models imports this module
        from repro_torch.models.ssm import ssd_chunked

        return ssd_chunked(x, dt, a, b, c, chunk=chunk)
    if devices == {"cuda"}:
        refuse_grad(x, dt, a, b, c)
        out = kernel.ssd_scan_fwd(x, dt, a, b, c, chunk=chunk)
        ssd_scan.launches += 1
        ssd_scan.launches_by_dtype[str(x.dtype).removeprefix("torch.")] += 1
        return out
    if devices == {"meta"}:  # the shape function: the launch's contract, no launch
        refuse_grad(x, dt, a, b, c)
        kernel._check(x, dt, a, b, c, chunk, device="meta")
        flops, nbytes = launch_cost(x, dt, a, b, c, chunk=chunk)
        bsz, _, h, p = x.shape
        shape = f"H={h} P={p} G={b.shape[2]} N={b.shape[3]}, {s} by chunks of {chunk}"
        report_meta_launch("ssd_scan_fwd", flops=flops, nbytes=nbytes, shape=shape)
        return (torch.empty(x.shape, dtype=x.dtype, device="meta"),
                torch.empty((bsz, h, p, b.shape[3]), dtype=torch.float32, device="meta"))
    raise ValueError(f"ssd_scan: tensors on {sorted(devices)}; takes all-CPU or all-CUDA "
                     "(or all-meta: the shape function)")


ssd_scan.launches = 0
ssd_scan.launches_by_dtype = {"bfloat16": 0, "float32": 0}

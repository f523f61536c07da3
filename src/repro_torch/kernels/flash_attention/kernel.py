"""Bind and launch the Hopper flash-attention kernel
(``csrc/flash_attention.cu``; the counterpart of the Pallas kernel
``repro/kernels/flash_attention/kernel.py::flash_attention_fwd``).

The CUDA source is compiled at first use by
:func:`repro_torch.kernels.nvcc.compile_and_load` (``nvcc``, ``sm_90a``, a
plain C entry point loaded with ``ctypes``).  Nothing is compiled or loaded
when this module is imported.

The launch takes tensors in the model layout ``[B, S, H, D]`` with their
strides and a ``q_offset`` (row i of q at position ``q_offset + i`` in the
masks) (the head dim must be contiguous); v's head dim ``Dv`` may differ
from q's and k's ``D`` for the pairs the source instantiates
(:data:`HEAD_DIMS`: ``(d, d)`` for d in 8..256, and DeepSeek-V2's MLA
``(192, 128)``), and the output is ``[B, Sq, Hq, Dv]``.  It runs on
PyTorch's current stream, allocates nothing but the output, and raises on
any launch error.
The source holds two kernels and the dtype picks one: bfloat16 goes to the
tensor-core kernel, float32 to the CUDA-core kernel.  The tensor-core
kernel copies rows with 16-byte ``cp.async``, so a bfloat16 input whose row
bases are not 16-byte aligned is refused
(:func:`repro_torch.kernels.row_alignment`).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import row_alignment
from repro_torch.kernels.nvcc import compile_and_load, launch_error

__all__ = ["build", "flash_attention_fwd", "HEAD_DIMS", "ROW_ALIGN"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
# The (D, Dv) pairs both kernels are instantiated for (REPRO_FLASH_PAIRS in
# the source); the kernel returns -2 for any other.
HEAD_DIMS = ((8, 8), (16, 16), (32, 32), (64, 64), (128, 128), (256, 256), (192, 128))
ROW_ALIGN = 16  # bytes: the bfloat16 kernel's cp.async copies
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_REFUSALS = {
    -1: "unsupported dtype",
    -2: "unsupported (D, Dv) head dim pair",
    -3: "a bfloat16 row base is not 16-byte aligned",
}

# The loaded library and its build report, or None until the first launch.
_LIB: ctypes.CDLL | None = None
_REPORT: dict | None = None
_BUILD_LOCK = threading.Lock()


def build() -> tuple[ctypes.CDLL, dict]:
    """Compile (once per source hash) and load the kernel library; returns
    it with the build report (see ``compile_and_load``).  After the first
    call both come from memory."""
    global _LIB, _REPORT
    if _LIB is not None:
        return _LIB, _REPORT
    with _BUILD_LOCK:  # worker threads may launch the first kernel together
        if _LIB is not None:
            return _LIB, _REPORT
        lib, report = compile_and_load(SOURCE, "flash_attention")
        fn = lib.repro_flash_attention_fwd
        fn.argtypes = (
            [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 8
            + [ctypes.c_longlong] * 12
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _LIB, _REPORT = lib, report
        return lib, report


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, device: str = "cuda") -> None:
    """The launch's shape and dtype contract, on CUDA tensors (or, for the
    wrapper's shape function, on meta ones: ``device="meta"``)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != device:
            raise ValueError(f"flash_attention_fwd: {name} is on {t.device}, not "
                             f"{'CUDA' if device == 'cuda' else device}")
        if t.dim() != 4:
            raise ValueError(
                f"flash_attention_fwd: {name} must be [B, S, H, D], got {tuple(t.shape)}"
            )
        if t.dtype not in _DTYPES:
            raise TypeError(
                f"flash_attention_fwd: {name} dtype {t.dtype} (takes float32, bfloat16)"
            )
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention_fwd: {name} head dim must be contiguous")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention_fwd: q, k, v on different devices")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention_fwd: q, k, v dtypes differ")
    b, _, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or v.shape[:3] != k.shape[:3]:
        raise ValueError(
            f"flash_attention_fwd: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} (k must be [B, Skv, Hkv, D] and v [B, Skv, Hkv, Dv])"
        )
    if hq % k.shape[2]:
        raise ValueError(f"flash_attention_fwd: {hq} q heads over {k.shape[2]} kv heads")
    if (d, v.shape[3]) not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention_fwd: head dims (D, Dv) = {(d, v.shape[3])}: the kernels are "
            f"instantiated for {HEAD_DIMS} only"
        )


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    window: int,
    scale: float,
    q_offset: int = 0,
) -> torch.Tensor:
    """Launch the kernel once: q [B,Sq,Hq,D], k [B,Skv,Hkv,D], v [B,Skv,Hkv,Dv]
    → o [B,Sq,Hq,Dv]; q's rows at positions ``q_offset ..``."""
    _check(q, k, v)
    if q_offset < 0:
        raise ValueError(f"flash_attention_fwd: q_offset {q_offset} < 0")
    if q.dtype == torch.bfloat16 and (got := row_alignment(q, k, v)) < ROW_ALIGN:
        raise ValueError(
            f"flash_attention_fwd: the bfloat16 kernel copies {ROW_ALIGN}-byte rows; the rows "
            f"of q, k, v are only {got}-byte aligned (data pointer or strides)"
        )
    lib, _ = build()
    b, sq, hq, d = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    o = torch.empty((b, sq, hq, dv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _DTYPES[q.dtype],
            b, sq, skv, hq, hkv, d, dv,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            float(scale), int(causal), int(window), int(q_offset), stream,
        )
    if err != 0:
        raise launch_error(lib, err, "flash_attention_fwd", _REFUSALS.get(err, "refused"))
    return o

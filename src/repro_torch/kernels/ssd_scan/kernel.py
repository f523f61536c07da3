"""Bind and launch the Hopper SSD chunk-scan kernel (``csrc/ssd_scan.cu``;
the counterpart of the Pallas kernel
``repro/kernels/ssd_scan/kernel.py::ssd_scan_fwd``).

The CUDA source is compiled at first use by
:func:`repro_torch.kernels.nvcc.compile_and_load`.  Nothing is compiled or
loaded when this module is imported.  The launch reads the model layout
through strides (the last dim of x, B and C contiguous), runs on PyTorch's
current stream, allocates only its outputs, and raises on any launch error.
The source holds two kernels and the dtype of x, B and C picks one:
bfloat16 goes to the tensor-core kernel, float32 to the CUDA-core kernel.
The tensor-core kernel copies rows with ``cp.async`` of 16, 8 or 4 bytes,
the widest every row allows (:func:`repro_torch.kernels.row_alignment`; the
kernel works out the same); a bfloat16 input whose rows are not even
4-byte aligned is refused.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import row_alignment
from repro_torch.kernels.nvcc import compile_and_load, launch_error

__all__ = ["build", "ssd_scan_fwd", "MAX_STATE", "ROW_ALIGN"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
MAX_STATE = 128
ROW_ALIGN = 4  # bytes: the narrowest cp.async copy of the bfloat16 kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_REFUSALS = {
    -1: "unsupported dtype",
    -2: "bad shape (state > 128, chunk not dividing seq, groups not dividing heads)",
    -3: "the chunk needs more shared memory than a block has",
    -4: "a bfloat16 row of x, B or C is not 4-byte aligned",
}

_LIB: ctypes.CDLL | None = None
_REPORT: dict | None = None
_BUILD_LOCK = threading.Lock()


def build() -> tuple[ctypes.CDLL, dict]:
    """Compile (once per source hash) and load the library; returns it with
    the build report.  After the first call both come from memory."""
    global _LIB, _REPORT
    if _LIB is not None:
        return _LIB, _REPORT
    with _BUILD_LOCK:  # worker threads may launch the first kernel together
        if _LIB is not None:
            return _LIB, _REPORT
        lib, report = compile_and_load(SOURCE, "ssd_scan")
        fn = lib.repro_ssd_scan_fwd
        fn.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 15 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _LIB, _REPORT = lib, report
        return lib, report


def _check(x, dt, a, b, c, chunk: int, device: str = "cuda") -> None:
    """The launch's shape and dtype contract, on CUDA tensors (or, for the
    wrapper's shape function, on meta ones: ``device="meta"``)."""
    for name, t in (("x", x), ("dt", dt), ("a", a), ("b", b), ("c", c)):
        if t.device.type != device:
            raise ValueError(f"ssd_scan_fwd: {name} is on {t.device}, not "
                             f"{'CUDA' if device == 'cuda' else device}")
    if x.dtype not in _DTYPES or not (x.dtype == b.dtype == c.dtype):
        raise TypeError(
            f"ssd_scan_fwd: x/b/c dtypes {x.dtype}, {b.dtype}, {c.dtype} "
            "(one of float32, bfloat16)"
        )
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"ssd_scan_fwd: dt {dt.dtype} and a {a.dtype} must be float32")
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or b.dim() != 4 or b.shape != c.shape:
        raise ValueError("ssd_scan_fwd: want x [B,S,H,P], dt [B,S,H], a [H], b/c [B,S,G,N]")
    bsz, s, h, _ = x.shape
    g, n = b.shape[2], b.shape[3]
    if tuple(dt.shape) != (bsz, s, h) or tuple(a.shape) != (h,) or b.shape[:2] != x.shape[:2]:
        raise ValueError(
            f"ssd_scan_fwd: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
            f"a {tuple(a.shape)}, b {tuple(b.shape)}"
        )
    if h % g or n > MAX_STATE or s % chunk:
        raise ValueError(
            f"ssd_scan_fwd: {h} heads over {g} groups, state {n} (at most {MAX_STATE}), "
            f"seq {s} by chunk {chunk}"
        )
    if any(t.stride(-1) != 1 for t in (x, b, c)) or not a.is_contiguous():
        raise ValueError("ssd_scan_fwd: the last dim of x, b, c (and a) must be contiguous")
    if len({t.device for t in (x, dt, a, b, c)}) != 1:
        raise ValueError("ssd_scan_fwd: tensors on different devices")


def ssd_scan_fwd(
    x: torch.Tensor,   # [B, S, H, P]
    dt: torch.Tensor,  # [B, S, H]
    a: torch.Tensor,   # [H]
    b: torch.Tensor,   # [B, S, G, N]
    c: torch.Tensor,   # [B, S, G, N]
    *,
    chunk: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel once → (y [B,S,H,P] in x's dtype, h_final [B,H,P,N] fp32)."""
    _check(x, dt, a, b, c, chunk)
    if x.dtype == torch.bfloat16 and (got := row_alignment(x, b, c)) < ROW_ALIGN:
        raise ValueError(
            f"ssd_scan_fwd: the bfloat16 kernel copies rows at least {ROW_ALIGN} bytes at a "
            f"time; the rows of x, b, c are only {got}-byte aligned (data pointer, strides or "
            "last dim)"
        )
    lib, _ = build()
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    h_final = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            y.data_ptr(), h_final.data_ptr(), _DTYPES[x.dtype], bsz, s, h, g, p, n, chunk,
            *x.stride()[:3], *dt.stride(), *b.stride()[:3], *c.stride()[:3], *y.stride()[:3],
            stream,
        )
    if err != 0:
        raise launch_error(lib, err, "ssd_scan_fwd", _REFUSALS.get(err, "refused"))
    return y, h_final

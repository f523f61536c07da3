"""Bind and launch the Hopper block-quant kernels (``csrc/block_quant.cu``;
the counterparts of the Pallas kernels
``repro/kernels/block_quant/kernel.py::quantize_blocks_pallas`` and
``::dequantize_blocks_pallas``).

The CUDA source is compiled at first use by
:func:`repro_torch.kernels.nvcc.compile_and_load`.  Nothing is compiled or
loaded when this module is imported.  Each launch runs on PyTorch's current
stream, allocates only its outputs, and raises on any launch error.

The source holds two variants of each kernel, and :func:`variant` picks one
from the row width and the pointers alone (no switch, no environment):
``"vector"`` (a row in registers, 16-byte loads, several rows a block) and
``"general"`` (one block a row, any width and alignment).  Each launch
returns the variant it took.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.nvcc import compile_and_load, launch_error

from .ref import FMAX, QDTYPES, qdtype_name, reciprocal

__all__ = ["VECTOR_MAX_N", "build", "dequantize_blocks", "quantize_blocks", "variant"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "block_quant.cu"
_QKIND = {"int8": 0, "float8_e4m3fn": 1, "float8_e5m2": 2}

VECTOR_MAX_N = 1024  # the widest row the vector kernels hold in registers

_LIB: ctypes.CDLL | None = None
_REPORT: dict | None = None


def build() -> tuple[ctypes.CDLL, dict]:
    """Compile (once per source hash) and load the library; returns it with
    the build report.  After the first call both come from memory."""
    global _LIB, _REPORT
    if _LIB is not None:
        return _LIB, _REPORT
    lib, report = compile_and_load(SOURCE, "block_quant")
    for fn in (lib.repro_block_quantize, lib.repro_block_quantize_vec):
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    for fn in (lib.repro_block_dequantize, lib.repro_block_dequantize_vec):
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    _LIB, _REPORT = lib, report
    return lib, report


def variant(n: int, *pointers: int) -> str:
    """The kernel a launch takes for rows of ``n`` elements: ``"vector"``
    when ``n`` is a multiple of 8 up to :data:`VECTOR_MAX_N` and every
    pointer the kernel moves 16 bytes at a time through (the fp32 side and
    the codes) is 16-byte aligned, else ``"general"``."""
    if 0 < n <= VECTOR_MAX_N and n % 8 == 0 and all(p % 16 == 0 for p in pointers):
        return "vector"
    return "general"


def _require(t: torch.Tensor, what: str, dtype: torch.dtype, dim: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what} is on {t.device}, not CUDA")
    if t.dtype != dtype:
        raise TypeError(f"{what} dtype {t.dtype}, want {dtype}")
    if t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {dim}-d tensor, got {tuple(t.shape)}")


def _stream(t: torch.Tensor) -> int:
    with torch.cuda.device(t.device):
        return torch.cuda.current_stream().cuda_stream


def quantize_blocks(blocks: torch.Tensor, *, dtype) -> tuple[torch.Tensor, torch.Tensor, str]:
    """One launch: fp32 ``[nblocks, n]`` → ``(q [nblocks, n], scales [nblocks],
    variant)``."""
    name = qdtype_name(dtype)
    _require(blocks, "quantize_blocks: blocks", torch.float32, 2)
    lib, _ = build()
    nblocks, n = blocks.shape
    q = torch.empty((nblocks, n), dtype=QDTYPES[name], device=blocks.device)
    scales = torch.empty((nblocks,), dtype=torch.float32, device=blocks.device)
    which = variant(n, blocks.data_ptr(), q.data_ptr())
    fn = lib.repro_block_quantize_vec if which == "vector" else lib.repro_block_quantize
    err = fn(
        blocks.data_ptr(), q.data_ptr(), scales.data_ptr(), nblocks, n, _QKIND[name],
        FMAX[name], reciprocal(name), _stream(blocks),
    )
    if err != 0:
        raise launch_error(lib, err, f"quantize_blocks ({which})", "bad format, shape or alignment")
    return q, scales, which


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor) -> tuple[torch.Tensor, str]:
    """One launch: ``(q [nblocks, n], scales [nblocks])`` → (fp32 ``[nblocks, n]``,
    variant)."""
    name = qdtype_name(q.dtype)
    _require(q, "dequantize_blocks: q", q.dtype, 2)
    _require(scales, "dequantize_blocks: scales", torch.float32, 1)
    if q.device != scales.device or scales.shape[0] != q.shape[0]:
        raise ValueError(
            f"dequantize_blocks: q {tuple(q.shape)} on {q.device}, "
            f"scales {tuple(scales.shape)} on {scales.device}"
        )
    lib, _ = build()
    nblocks, n = q.shape
    out = torch.empty((nblocks, n), dtype=torch.float32, device=q.device)
    which = variant(n, q.data_ptr(), out.data_ptr())
    fn = lib.repro_block_dequantize_vec if which == "vector" else lib.repro_block_dequantize
    err = fn(q.data_ptr(), scales.data_ptr(), out.data_ptr(), nblocks, n, _QKIND[name], _stream(q))
    if err != 0:
        raise launch_error(lib, err, f"dequantize_blocks ({which})", "bad format, shape or alignment")
    return out, which

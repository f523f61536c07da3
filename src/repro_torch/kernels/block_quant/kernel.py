"""Bind and launch the Hopper block-quant kernels (``csrc/block_quant.cu``;
the counterparts of the Pallas kernels
``repro/kernels/block_quant/kernel.py::quantize_blocks_pallas`` and
``::dequantize_blocks_pallas``).

The CUDA source is compiled at first use by
:func:`repro_torch.kernels.nvcc.compile_and_load`.  Nothing is compiled or
loaded when this module is imported.  Each launch runs on PyTorch's current
stream, allocates only its outputs, and raises on any launch error.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.nvcc import compile_and_load, launch_error

from .ref import FMAX, QDTYPES, qdtype_name, reciprocal

__all__ = ["build", "quantize_blocks", "dequantize_blocks"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "block_quant.cu"
_QKIND = {"int8": 0, "float8_e4m3fn": 1, "float8_e5m2": 2}

_LIB: ctypes.CDLL | None = None
_REPORT: dict | None = None


def build() -> tuple[ctypes.CDLL, dict]:
    """Compile (once per source hash) and load the library; returns it with
    the build report.  After the first call both come from memory."""
    global _LIB, _REPORT
    if _LIB is not None:
        return _LIB, _REPORT
    lib, report = compile_and_load(SOURCE, "block_quant")
    lib.repro_block_quantize.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    lib.repro_block_quantize.restype = ctypes.c_int
    lib.repro_block_dequantize.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.repro_block_dequantize.restype = ctypes.c_int
    _LIB, _REPORT = lib, report
    return lib, report


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


def quantize_blocks(blocks: torch.Tensor, *, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch: fp32 ``[nblocks, n]`` → ``(q [nblocks, n], scales [nblocks])``."""
    name = qdtype_name(dtype)
    _require(blocks, "quantize_blocks: blocks", torch.float32, 2)
    lib, _ = build()
    nblocks, n = blocks.shape
    q = torch.empty((nblocks, n), dtype=QDTYPES[name], device=blocks.device)
    scales = torch.empty((nblocks,), dtype=torch.float32, device=blocks.device)
    err = lib.repro_block_quantize(
        blocks.data_ptr(), q.data_ptr(), scales.data_ptr(), nblocks, n, _QKIND[name],
        FMAX[name], reciprocal(name), _stream(blocks),
    )
    if err != 0:
        raise launch_error(lib, err, "quantize_blocks", "bad format or shape")
    return q, scales


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """One launch: ``(q [nblocks, n], scales [nblocks])`` → fp32 ``[nblocks, n]``."""
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
    err = lib.repro_block_dequantize(
        q.data_ptr(), scales.data_ptr(), out.data_ptr(), nblocks, n, _QKIND[name], _stream(q),
    )
    if err != 0:
        raise launch_error(lib, err, "dequantize_blocks", "bad format or shape")
    return out

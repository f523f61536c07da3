"""Build, bind and launch the Hopper flash-attention kernel
(``csrc/flash_attention.cu``; the counterpart of the Pallas kernel
``repro/kernels/flash_attention/kernel.py::flash_attention_fwd``).

The CUDA source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C entry point, under ``build/repro_torch/`` of
the checkout, named by a hash of the source and flags so a changed source
rebuilds; it is loaded with ``ctypes``.  Nothing is compiled or loaded when
this module is imported.

The launch takes tensors in the model layout ``[B, S, H, D]`` with their
strides (the head dim must be contiguous), runs on PyTorch's current
stream, allocates nothing but the output, and raises on any launch error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["build", "flash_attention_fwd", "HEAD_DIMS", "NVCC_FLAGS"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The loaded library and its build report, or None until the first launch.
_LIB: ctypes.CDLL | None = None
_REPORT: dict | None = None


def _build_dir() -> Path:
    # src/repro_torch/kernels/flash_attention/kernel.py -> the checkout root
    return Path(__file__).resolve().parents[4] / "build" / "repro_torch"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build() -> tuple[ctypes.CDLL, dict]:
    """Compile (once per source hash) and load the kernel library.

    Returns the library and a report: the library path, whether it was
    compiled by this process, the compile seconds, and ``nvcc``'s
    ``ptxas -v`` output (registers, shared memory and spills per
    instantiation).  After the first call both come from memory.
    """
    global _LIB, _REPORT
    if _LIB is not None:
        return _LIB, _REPORT
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _build_dir() / f"flash_attention_{tag}.so"
    report = {"library": str(out), "compiled": False, "seconds": 0.0, "ptxas": ""}
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        t0 = time.perf_counter()
        res = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True, check=False,
        )
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{res.stderr[-4000:]}")
        os.replace(tmp, out)
        report.update(compiled=True, seconds=time.perf_counter() - t0, ptxas=res.stderr)
    lib = ctypes.CDLL(str(out))
    fn = lib.repro_flash_attention_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 7
        + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    _LIB, _REPORT = lib, report
    return lib, report


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention_fwd: {name} is on {t.device}, not CUDA")
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
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            f"flash_attention_fwd: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} (k and v must equal [B, Skv, Hkv, D])"
        )
    if hq % k.shape[2]:
        raise ValueError(f"flash_attention_fwd: {hq} q heads over {k.shape[2]} kv heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head dim {d} not in {HEAD_DIMS}")


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    window: int,
    scale: float,
) -> torch.Tensor:
    """Launch the kernel once: q [B,Sq,Hq,D], k/v [B,Skv,Hkv,D] → o [B,Sq,Hq,D]."""
    _check(q, k, v)
    lib, _ = build()
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    o = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _DTYPES[q.dtype],
            b, sq, skv, hq, hkv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            float(scale), int(causal), int(window), stream,
        )
    if err != 0:
        what = (
            lib.repro_cuda_error_string(err).decode() if err > 0
            else "unsupported dtype or head dim"
        )
        raise RuntimeError(f"flash_attention_fwd launch failed ({err}: {what})")
    return o

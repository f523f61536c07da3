"""Build a CUDA source of the port into a shared library and load it.

Every Hopper kernel of the port is a ``.cu`` file with a plain C entry point
under its package's ``csrc/``.  :func:`compile_and_load` compiles it with
``nvcc`` for ``sm_90a`` into ``build/repro_torch/`` of the checkout, named by
a hash of the source and flags (a changed source rebuilds), and loads it
with ``ctypes``.  Nothing is compiled when a module is imported: each kernel
module calls this at its first launch, under its own lock (the parallel
checkpoint engine launches kernels from several worker threads at once).
Builds of different sources may run in parallel threads (each is one
``nvcc`` process); every build writes a temporary file of its own name and
renames it into place, so no build ever loads another's half-written
library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
import uuid
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_dir", "compile_and_load", "launch_error"]

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def build_dir() -> Path:
    # src/repro_torch/kernels/nvcc.py -> the checkout root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def compile_and_load(source: Path, stem: str) -> tuple[ctypes.CDLL, dict]:
    """Compile ``source`` (once per source hash) and load the library.

    Returns the library and a report: the library path, whether this
    process compiled it, the compile seconds and ``ptxas -v``'s output
    (registers, shared memory and spills per kernel)."""
    tag = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = build_dir() / f"{stem}_{tag}.so"
    report = {"library": str(out), "compiled": False, "seconds": 0.0, "ptxas": ""}
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.{uuid.uuid4().hex}.tmp.so")
        t0 = time.perf_counter()
        res = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            capture_output=True, text=True, check=False,
        )
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {source}:\n{res.stderr[-4000:]}")
        os.replace(tmp, out)
        report.update(compiled=True, seconds=time.perf_counter() - t0, ptxas=res.stderr)
    lib = ctypes.CDLL(str(out))
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib, report


def launch_error(lib: ctypes.CDLL, err: int, kernel: str, refusal: str) -> RuntimeError:
    """The exception for a non-zero return of a C entry point: a positive
    value is a ``cudaError_t``, a negative one the entry's own ``refusal``."""
    text = lib.repro_cuda_error_string(err).decode() if err > 0 else refusal
    return RuntimeError(f"{kernel} launch failed ({err}: {text})")

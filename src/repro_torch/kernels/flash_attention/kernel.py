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
The source holds three kernels, and the dtype, then the head dims, pick
one (:func:`variant`): bfloat16 at D >= 64 goes to ``"wgmma"`` (Hopper's
warpgroup products fed by TMA, a producer warpgroup and two consumers),
bfloat16 at D <= 32 to ``"mma"`` (``mma.sync`` with ``cp.async`` copies),
float32 to ``"fp32"`` (CUDA cores).  Both bfloat16 kernels copy rows 16
bytes at a time (TMA boxes, ``cp.async``), so a bfloat16 input whose row
bases are not 16-byte aligned is refused
(:func:`repro_torch.kernels.row_alignment`).  :data:`KV_TILE` is each bf16
instance's KV tile, where its online softmax takes the running max: the
only thing that moves its rounding.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import row_alignment
from repro_torch.kernels.nvcc import compile_and_load, launch_error

__all__ = ["build", "flash_attention_fwd", "variant", "HEAD_DIMS", "KV_TILE", "ROW_ALIGN"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
# The (D, Dv) pairs both kernels are instantiated for (REPRO_FLASH_PAIRS in
# the source); the kernel returns -2 for any other.
HEAD_DIMS = ((8, 8), (16, 16), (32, 32), (64, 64), (128, 128), (256, 256), (192, 128))
# The KV rows of a tile of each bf16 instance (REPRO_WGMMA_TILES, and
# TC_BK for REPRO_MMA_PAIRS, in the source).
KV_TILE = {(8, 8): 64, (16, 16): 64, (32, 32): 64,
           (64, 64): 128, (128, 128): 128, (256, 256): 64, (192, 128): 128}
ROW_ALIGN = 16  # bytes: the bfloat16 kernels' TMA boxes and cp.async copies
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_REFUSALS = {
    -1: "unsupported dtype",
    -2: "unsupported (D, Dv) head dim pair",
    -3: "a bfloat16 row base is not 16-byte aligned",
    -4: "cuTensorMapEncodeTiled refused a TMA tensor map",
    -5: "libcuda has no cuTensorMapEncodeTiled",
}

# The loaded library and its build report, or None until the first launch.
_LIB: ctypes.CDLL | None = None
_REPORT: dict | None = None
_BUILD_LOCK = threading.Lock()
# The wgmma kernel's tile counters, one pair of ints a (device, stream):
# zero when made, and each launch leaves them at zero for the next launch on
# its stream (launches on one stream never overlap; on two streams they may).
_SCHED: dict[tuple[int, int], torch.Tensor] = {}
_SCHED_LOCK = threading.Lock()


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
            [ctypes.c_void_p] * 5
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


def _sched(device: torch.device, stream: int) -> torch.Tensor:
    """The tile counters for launches on ``stream`` of ``device``."""
    key = (device.index, stream)
    with _SCHED_LOCK:
        if key not in _SCHED:
            _SCHED[key] = torch.zeros(2, dtype=torch.int32, device=device)
        return _SCHED[key]


def variant(q: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel a launch takes: ``"fp32"`` for float32; for bfloat16
    ``"wgmma"`` at q's head dim 64 and up, ``"mma"`` below it."""
    if q.dtype == torch.float32:
        return "fp32"
    return "wgmma" if q.shape[-1] >= 64 else "mma"


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
            f"flash_attention_fwd: the bfloat16 kernels copy {ROW_ALIGN}-byte rows; the rows "
            f"of q, k, v are only {got}-byte aligned (data pointer or strides)"
        )
    lib, _ = build()
    b, sq, hq, d = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    o = torch.empty((b, sq, hq, dv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _sched(q.device, stream).data_ptr(), _DTYPES[q.dtype],
            b, sq, skv, hq, hkv, d, dv,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            float(scale), int(causal), int(window), int(q_offset), stream,
        )
    if err != 0:
        raise launch_error(lib, err, "flash_attention_fwd", _REFUSALS.get(err, "refused"))
    return o

"""Tensor file I/O for checkpoints: ``.npy`` with dtype-faithful views.

Port of ``repro.core.tensor_io``.  The on-disk format is the reference's:
plain ``.npy`` files, and content digests over the C-order element bytes,
so a shard written by either package verifies and reads in the other.

NumPy has no ``bfloat16`` or fp8 types, and this package does not use
``ml_dtypes``.  Those dtypes are carried by torch instead: on disk they are
an anonymous 2- or 1-byte void (what ``np.save`` writes for an ``ml_dtypes``
array), and :func:`load_tensor` returns them as a torch tensor viewed as
the torch dtype of the same name.  They are never handed out as ``uint16``
or ``uint8`` numbers.  The numpy checkpoint path (saver, engine, restore)
takes float32 and the other numpy dtypes; :func:`resolve_dtype` refuses the
extended names so that path cannot silently mistype them.
"""

from __future__ import annotations

import hashlib
import os
import zlib
from pathlib import Path

import numpy as np
import torch

__all__ = [
    "EXTENDED_DTYPES",
    "IntegrityError",
    "content_digest",
    "digest_matches",
    "dtype_name",
    "resolve_dtype",
    "torch_dtype",
    "staging_like",
    "to_staging",
    "save_tensor",
    "fsync_path",
    "load_tensor",
    "open_memmap",
]

# name -> (torch dtype, numpy integer type of the same width used for the view)
EXTENDED_DTYPES: dict[str, tuple[torch.dtype, type]] = {
    "bfloat16": (torch.bfloat16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, np.uint8),
}
_BY_TORCH = {t: (name, bits) for name, (t, bits) in EXTENDED_DTYPES.items()}


class IntegrityError(ValueError):
    """A checkpoint's bytes do not match its recorded content digests."""


def _raw_bytes_view(arr) -> np.ndarray:
    """C-contiguous numpy view of an array's element bytes.

    A torch tensor of an extended dtype is reinterpreted through an integer
    type of the same width; any other tensor goes through ``.numpy()``."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype in _BY_TORCH:
            bits = _BY_TORCH[t.dtype][1]
            t = t.view(torch.uint16 if bits is np.uint16 else torch.uint8)
        return t.numpy()
    return np.ascontiguousarray(arr)


def content_digest(arr, algo: str = "sha256") -> str:
    """Digest of an array's *content* bytes (layout/file-header agnostic).

    ``<algo>:<hex>`` over the C-order element bytes; sha256 truncated to
    128 bits by default, ``crc32`` for manifests that predate it — the same
    digests as ``repro.core.tensor_io.content_digest``.  Takes a numpy array
    or a torch tensor (extended dtypes included).
    """
    a = _raw_bytes_view(arr)
    try:
        buf = memoryview(a).cast("B")
    except (TypeError, ValueError, BufferError):
        # void dtypes may not export a buffer format: hash the raw bytes.
        buf = a.tobytes()
    if algo == "sha256":
        return f"sha256:{hashlib.sha256(buf).hexdigest()[:32]}"
    if algo == "crc32":
        return f"crc32:{zlib.crc32(buf) & 0xFFFFFFFF:08x}"
    raise ValueError(f"unknown digest algorithm {algo!r}")


def digest_matches(arr, recorded: str) -> bool:
    """Whether an array's content matches a recorded digest, by the
    algorithm the digest names (old manifests carry crc32).  A malformed or
    unrecognized recorded digest matches nothing: it is a mismatch, never
    an exception (validation turns corruption into findings)."""
    try:
        return content_digest(arr, recorded.split(":", 1)[0]) == recorded
    except ValueError:
        return False


def resolve_dtype(name: str) -> np.dtype:
    """numpy dtype of a checkpoint dtype name.

    Raises for ``bfloat16`` and fp8: numpy cannot hold them, and the numpy
    checkpoint path of this port does not take them yet (ROADMAP queue 1,
    item 3).  Read such files with :func:`load_tensor`."""
    if name in EXTENDED_DTYPES:
        raise NotImplementedError(
            f"{name} state on the numpy checkpoint path is not ported yet "
            "(ROADMAP queue 1, item 3: the rest of the checkpoint path); "
            "load_tensor reads it as a torch tensor"
        )
    return np.dtype(name)


def dtype_name(dtype) -> str:
    """Checkpoint name of a numpy or torch dtype (``float32``, ``bfloat16``…)."""
    if isinstance(dtype, torch.dtype):
        if dtype in _BY_TORCH:
            return _BY_TORCH[dtype][0]
        return np.dtype(torch.empty(0, dtype=dtype).numpy().dtype).name
    return np.dtype(dtype).name


def torch_dtype(name: str) -> torch.dtype:
    """torch dtype of a checkpoint dtype name (extended names included)."""
    if name in EXTENDED_DTYPES:
        return EXTENDED_DTYPES[name][0]
    return torch.from_numpy(np.empty(0, np.dtype(name))).dtype


def staging_like(pieces, shape, dtype, *, zero: bool, alloc=None):
    """A staging buffer for ``pieces``: a torch tensor on their device when
    any of them is a tensor (coded moments decoded on the card), else a
    numpy array — or a CPU tensor for a dtype numpy cannot hold.

    ``alloc``: optional ``(shape, dtype, zero=...) -> ndarray`` allocator
    of the numpy buffers (the engine's :class:`~repro_torch.core.engine.BufferArena`);
    tensors come from PyTorch's own caching allocator."""
    dev = next((p.device for p in pieces if isinstance(p, torch.Tensor)), None)
    shape = tuple(int(s) for s in shape)
    name = dtype if isinstance(dtype, str) else dtype_name(dtype)
    if dev is None and name not in EXTENDED_DTYPES:
        dt = np.dtype(name)
        if alloc is not None:
            return alloc(shape, dt, zero=zero)
        return np.zeros(shape, dt) if zero else np.empty(shape, dt)
    tdt = torch_dtype(name)
    dev = dev if dev is not None else torch.device("cpu")
    alloc = torch.zeros if zero else torch.empty
    return alloc(shape, dtype=tdt, device=dev)


def to_staging(out, piece):
    """``piece`` in the kind of ``out``: a host array goes to ``out``'s
    device, a tensor into a numpy ``out`` comes to the host."""
    if isinstance(out, torch.Tensor) and not isinstance(piece, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(piece)).to(out.device)
    if isinstance(piece, torch.Tensor) and not isinstance(out, torch.Tensor):
        return piece.cpu().numpy()
    return piece


def save_tensor(path: str | os.PathLike, arr, *, fsync: bool = True) -> None:
    """Atomically write an array (tmp + rename) so readers never see torn files.

    ``arr`` is a numpy array or a torch tensor; a tensor of an extended
    dtype is written as an anonymous void of its width, as the reference
    writes its ``ml_dtypes`` arrays.  ``fsync=False`` defers durability to
    the caller (:func:`fsync_path` before the checkpoint's COMMIT).
    """
    if isinstance(arr, torch.Tensor):
        raw = _raw_bytes_view(arr)
        if arr.dtype in _BY_TORCH:
            raw = raw.view(np.dtype((np.void, raw.dtype.itemsize)))
        arr = raw
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        np.save(f, arr)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.replace(tmp, path)


def fsync_path(path: str | os.PathLike) -> None:
    """Flush one already-written file to stable storage (the parallel
    saver's per-file fsync, run in the worker that wrote it)."""
    fd = os.open(str(path), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def load_tensor(path: str | os.PathLike, dtype: str | None = None, *, mmap: bool = True):
    """Load (lazily when ``mmap``) and restore the logical dtype.

    Returns a numpy array for numpy dtypes, and a CPU torch tensor of the
    torch dtype for ``bfloat16``/fp8 (a view of the file's bytes).  Raises
    when the stored item size cannot hold the requested dtype.
    """
    arr = np.load(path, mmap_mode="r" if mmap else None)
    if dtype is None:
        return arr
    if dtype in EXTENDED_DTYPES:
        tdt, bits = EXTENDED_DTYPES[dtype]
        if arr.dtype.itemsize != np.dtype(bits).itemsize:
            raise ValueError(
                f"{path}: stored itemsize {arr.dtype.itemsize} cannot view as {dtype}"
            )
        raw = np.array(arr.view(bits))  # torch cannot wrap a read-only mmap
        return torch.from_numpy(raw).view(tdt)
    want = np.dtype(dtype)
    if arr.dtype != want:
        if arr.dtype.itemsize != want.itemsize:
            raise ValueError(
                f"{path}: stored itemsize {arr.dtype.itemsize} cannot view "
                f"as {dtype} (itemsize {want.itemsize})"
            )
        arr = arr.view(want)
    return arr


def open_memmap(path: str | os.PathLike, shape: tuple[int, ...], dtype: str) -> np.memmap:
    """Writable ``.npy`` memmap of a numpy dtype (constant-memory assembly)."""
    return np.lib.format.open_memmap(
        str(path), mode="w+", dtype=resolve_dtype(dtype), shape=shape
    )

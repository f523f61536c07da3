"""Tensor file I/O for checkpoints: ``.npy`` with dtype-faithful views.

Port of ``repro.core.tensor_io``.  The on-disk format is the reference's:
plain ``.npy`` files, and content digests over the C-order element bytes,
so a shard written by either package verifies and reads in the other.

NumPy has no ``bfloat16`` or fp8 types, and this package does not use
``ml_dtypes``.  Those dtypes are carried by torch instead: on disk they are
a 2- or 1-byte void with the header the reference's ``ml_dtypes`` arrays
get from ``np.save`` (``<V2`` for bfloat16, ``<V1`` for float8_e4m3fn; for
float8_e5m2, whose ``<f1`` header the reference's own ``np.load`` refuses,
an anonymous ``|V1``), and :func:`load_tensor` returns them as a torch
tensor viewed as the torch dtype of the same name.  They are never handed
out as ``uint16`` or ``uint8`` numbers.  On the numpy checkpoint path
(saver, engine, atom memmaps) :func:`resolve_dtype` gives them as that
void: a buffer of element bytes that numpy copies, slices and writes but
cannot compute with; values are cast to them through torch (round to
nearest even, as ``ml_dtypes`` casts in the reference).
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
    "array_nbytes",
    "content_digest",
    "digest_matches",
    "dtype_name",
    "resolve_dtype",
    "to_extended",
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
# ``.npy`` header descr of each extended dtype: the reference's, except
# float8_e5m2's '<f1', which np.load refuses (the reference's own files of
# it do not load); that one is written as the anonymous void.
_DESCR = {"bfloat16": "<V2", "float8_e4m3fn": "<V1", "float8_e5m2": "|V1"}


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


def array_nbytes(arr) -> int:
    """Element bytes of a numpy array or a torch tensor."""
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    return int(arr.nbytes)


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

    ``bfloat16`` and fp8 resolve to the void of their width: numpy holds
    and moves their element bytes, never reads them as numbers.  Cast
    values to them with :func:`to_extended`; read files of them as torch
    tensors with :func:`load_tensor`."""
    if name in EXTENDED_DTYPES:
        return np.dtype((np.void, np.dtype(EXTENDED_DTYPES[name][1]).itemsize))
    return np.dtype(name)


def to_extended(arr, name: str) -> torch.Tensor:
    """A host array as a CPU tensor of the extended dtype ``name``: numbers
    are cast through torch (round to nearest even, as ``ml_dtypes`` casts),
    a void array of the dtype's width is taken as its element bytes."""
    tdt, bits = EXTENDED_DTYPES[name]
    a = np.ascontiguousarray(arr)
    if a.dtype.kind == "V":
        if a.dtype.itemsize != np.dtype(bits).itemsize:
            raise ValueError(f"a {a.dtype} array cannot hold {name}")
        return torch.from_numpy(a.view(bits)).view(tdt)
    return torch.from_numpy(a).to(tdt)


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
    device, a tensor into a numpy ``out`` comes to the host (its element
    bytes when ``out`` is the void of an extended dtype)."""
    if isinstance(out, torch.Tensor) and not isinstance(piece, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(piece)).to(out.device)
    if isinstance(piece, torch.Tensor) and not isinstance(out, torch.Tensor):
        if piece.dtype in _BY_TORCH:
            return _raw_bytes_view(piece).view(out.dtype)
        return piece.cpu().numpy()
    return piece


def save_tensor(path: str | os.PathLike, arr, *, fsync: bool = True) -> None:
    """Atomically write an array (tmp + rename) so readers never see torn files.

    ``arr`` is a numpy array or a torch tensor; a tensor of an extended
    dtype is written as a void of its width under the reference's header
    (the bytes the reference's ``np.save`` of an ``ml_dtypes`` array
    writes; float8_e5m2 aside, see the module notes).  ``fsync=False``
    defers durability to the caller (:func:`fsync_path` before the
    checkpoint's COMMIT).
    """
    descr = None
    if isinstance(arr, torch.Tensor):
        if arr.dtype in _BY_TORCH:
            descr = _DESCR[_BY_TORCH[arr.dtype][0]]
        arr = _raw_bytes_view(arr)
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        if descr is None:
            np.save(f, arr)
        else:
            _write_header(f, descr, arr.shape)
            arr.tofile(f)
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


def _write_header(f, descr: str, shape) -> None:
    """The ``.npy`` header ``np.save`` writes for a C-order array of
    ``descr`` and ``shape``."""
    np.lib.format.write_array_header_1_0(
        f, {"descr": descr, "fortran_order": False, "shape": tuple(int(s) for s in shape)}
    )


def open_memmap(path: str | os.PathLike, shape: tuple[int, ...], dtype: str) -> np.memmap:
    """Writable ``.npy`` memmap (constant-memory assembly).  An extended
    dtype's file gets the reference's header, and the memmap is the void
    of its width (element bytes; :func:`to_staging` fills it from tensors)."""
    if dtype not in EXTENDED_DTYPES:
        return np.lib.format.open_memmap(
            str(path), mode="w+", dtype=resolve_dtype(dtype), shape=shape
        )
    shape = tuple(int(s) for s in shape)
    with open(path, "wb") as f:
        _write_header(f, _DESCR[dtype], shape)
        offset = f.tell()
        f.truncate(offset + int(np.prod(shape)) * resolve_dtype(dtype).itemsize)
    return np.memmap(path, dtype=resolve_dtype(dtype), mode="r+", offset=offset, shape=shape)

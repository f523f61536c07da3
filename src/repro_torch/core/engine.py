"""The shared checkpoint I/O engine: index, handle cache, worker pool
(port of ``repro.core.engine``).

Every save, convert and restore path of the port routes its file I/O
through a :class:`CheckpointEngine`, which owns:

* :class:`FragmentIndex` — a sorted interval index over the fragment
  atom-slices of one ``(checkpoint, param, kind)``, built once and cached:
  a region read touches only the fragments that overlap it;
* :class:`HandleCache` — a bounded, thread-safe LRU of open shard and atom
  handles keyed by file path, weighed by bytes: a restore of N parameters
  × R regions opens (and, for a coded shard, decodes) each file once.  Raw
  files are mmap'd under every profile, so their handles weigh nothing;
  a restore or export through the manager drops its checkpoint's handles
  when it ends;
* a bounded worker pool (:meth:`CheckpointEngine.map`) — shard writes,
  coded region reads and per-parameter conversion release the GIL
  (memcpy, sha256, file writes, fsync, CUDA launches), so they fan out
  over threads.  ``workers=1`` runs inline in the serial order: the
  reference's serial profile, kept so the parallel paths stay
  benchmarkable against it;
* :class:`BufferArena` — recycled host staging buffers for shard slicing
  and region assembly (warm pages, no first-touch faults);
* the fan-out sharing of :meth:`CheckpointEngine.shared_region` (each
  Target region of a publication assembled once per fleet) and
  :meth:`CheckpointEngine.memo` (a fleet's built weights, once per
  publication and Target layout), both in the atom cache.

A *fragment source* is anything with a ``.manifest`` (``params``, ``mesh``,
``save_mode``), ``.writing_ranks(name, kind)`` and
``.read_fragment(rank, name, kind, engine=)``: a
:class:`~repro_torch.core.dist_ckpt.DistCheckpoint` (fragments are shard
files) or a :class:`~repro_torch.hot.snapshot.HotSnapshot` (fragments are
surviving in-memory replicas, keyed by a ``cache_key`` that changes on
every rank failure).

While a tracer is enabled (:mod:`repro_torch.obs`) the engine counts arena
reuses and allocations, handle- and atom-cache hits, misses and evictions
and index builds, and hands the submitting span over to its pool workers.

An engine made for a CUDA ``device`` decodes coded fragments and atoms
there (the dequantize kernel), and the region reads that use them assemble
on the card; raw fragments stay host numpy
(:func:`~repro_torch.core.tensor_io.staging_like` is that rule).  Its
handle cache weighs a decoded card tensor by its bytes, so the byte bound
holds on the card too.  :func:`default_engine` keeps one engine per
device, so a CPU caller and a card caller never share decoded tensors.

Worker threads launch their CUDA work on the calling thread's current
stream, which in a plain thread is the device's default stream: the stream
the snapshot's copies and the restore's assembly run on, so every launch is
ordered after the data it reads.
"""

from __future__ import annotations

import bisect
import functools
import math
import os
import sys
import threading
from collections import OrderedDict
from collections.abc import Mapping
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Sequence

import numpy as np
import torch

import repro_torch.obs as obs

from .tensor_io import resolve_dtype

__all__ = [
    "BufferArena",
    "CheckpointEngine",
    "FragmentIndex",
    "HandleCache",
    "default_engine",
    "default_engines",
    "default_workers",
    "device_key",
    "source_cache_key",
]


def default_workers() -> int:
    """Pool width when the caller does not choose: enough threads to overlap
    fsync latency even on small hosts, bounded so huge hosts don't thrash."""
    return min(16, max(4, (os.cpu_count() or 2) * 2))


def source_cache_key(source) -> str:
    """Index-cache identity of a source (``cache_key``, else the root path)."""
    key = getattr(source, "cache_key", None)
    return key if key is not None else str(source.root)


def _key_under_root(key: str, root: str) -> bool:
    """Whether a cache key belongs to ``root``: the root itself, a delta
    variant (``root@delta:N``), a derived key (``root::atom::...``), or a
    file under it (``root/...``) — never a sibling that merely shares
    ``root`` as a string prefix (``root10`` vs ``root1``)."""
    if not key.startswith(root):
        return False
    rest = key[len(root):]
    return rest == "" or rest[0] in (os.sep, "@", ":")


def _np_dtype(dtype) -> np.dtype:
    return resolve_dtype(dtype) if isinstance(dtype, str) else np.dtype(dtype)


# ---------------------------------------------------------------------------
# Buffer arena
# ---------------------------------------------------------------------------


class _ArenaBuffer(np.ndarray):
    """Marker subclass: storage owned by a :class:`BufferArena`.  ``recycle``
    only reclaims storage whose ``.base`` chain bottoms out in one."""


class BufferArena:
    """Reusable host staging buffers for shard slicing and region assembly.

    Retired buffers (warm, already-faulted pages) wait on size-keyed free
    lists, so steady-state staging copies run at memcpy speed and
    parallelize.  **Reclamation is refcount-gated**: ``recycle`` parks a
    buffer on a pending list, and its storage re-enters the free lists only
    once the view chain ``alloc`` built has no outside referents — a
    ``torch.from_numpy`` tensor of it keeps it alive, so storage is never
    reused under a live alias.

    ``alloc(..., zero=False)`` skips clearing when the caller overwrites
    every element; a recycled buffer's contents are otherwise arbitrary.
    """

    def __init__(self, max_bytes: int = 1 << 30):
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._free: dict[int, list[np.ndarray]] = {}  #: guarded by self._lock
        self._pending: list[np.ndarray] = []  #: guarded by self._lock
        self._pooled_ids: set[int] = set()  #: guarded by self._lock
        self._retained = 0  #: guarded by self._lock
        self.allocs = 0
        self.reuses = 0

    @staticmethod
    def _bucket(nbytes: int) -> int:
        """Round up to a power of two (min one page) so near-miss sizes
        reuse each other's storage; waste is bounded at 2x."""
        size = 4096
        while size < nbytes:
            size <<= 1
        return size

    def _reap_locked(self) -> None:  # repro: holds[self._lock]
        """Move pending buffers whose view chains died onto the free lists."""
        still: list[np.ndarray] = []
        for raw in self._pending:
            # References when the chain is dead: the _pending list, the loop
            # variable and getrefcount's argument == 3; a live view adds one.
            if sys.getrefcount(raw) <= 3:
                if self._retained + raw.nbytes <= self.max_bytes:
                    self._free.setdefault(raw.nbytes, []).append(raw)
                    self._retained += raw.nbytes
                else:
                    self._pooled_ids.discard(id(raw))  # over budget: drop
            else:
                still.append(raw)
        self._pending = still

    def alloc(self, shape, dtype, *, zero: bool = True) -> np.ndarray:
        dt = _np_dtype(dtype)
        shape = tuple(int(s) for s in shape)
        nbytes = math.prod(shape) * dt.itemsize if shape else dt.itemsize
        bucket = self._bucket(max(nbytes, 1))
        raw = None
        with self._lock:
            self._reap_locked()
            stack = self._free.get(bucket)
            if stack:
                raw = stack.pop()
                self._retained -= raw.nbytes
                self._pooled_ids.discard(id(raw))
                self.reuses += 1
                obs.add("engine.arena.reuse")
            else:
                self.allocs += 1
                obs.add("engine.arena.alloc")
        if raw is None:
            raw = np.empty(bucket, np.uint8).view(_ArenaBuffer)
        # a plain-ndarray view (np.save and torch never see the marker
        # subclass); its .base chain still reaches the _ArenaBuffer.
        out = raw[:nbytes].view(dt).reshape(shape).view(np.ndarray)
        if zero:
            out[...] = np.zeros((), dt)
        return out

    def recycle(self, arr) -> None:
        """Offer an arena-backed array's storage back for reuse, once every
        view of it is gone; anything else passes through."""
        if not isinstance(arr, np.ndarray):
            return
        # the DEEPEST marker view is the bucket-sized buffer alloc() made
        node, base = arr, None
        while node is not None:
            if isinstance(node, _ArenaBuffer):
                base = node
            node = getattr(node, "base", None)
        if base is None:
            return
        with self._lock:
            if id(base) in self._pooled_ids:  # double-recycle guard
                return
            self._pooled_ids.add(id(base))
            self._pending.append(base)

    def clear(self) -> None:
        with self._lock:
            self._free.clear()
            self._pending.clear()
            self._pooled_ids.clear()
            self._retained = 0


# ---------------------------------------------------------------------------
# Handle cache
# ---------------------------------------------------------------------------


class HandleCache:
    """Bounded LRU of open array handles, keyed by file path.

    Values are whatever the loader returns: an ``np.load(mmap_mode)`` view,
    a materialized array, or a tensor (a coded shard decoded on the card, a
    bf16 state).  Bounded by entry count and by bytes: materialized arrays
    and tensors carry their weight, mmap views are nearly free.  Eviction
    drops the reference only, so an evicted handle stays safe to use.
    """

    def __init__(self, capacity: int = 128, max_bytes: int = 1 << 30,
                 metric: str = "engine.handle"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.max_bytes = int(max_bytes)
        # obs counter prefix: the engine's two caches (file handles,
        # consolidated atoms) count hit/miss/eviction under their own names,
        # precomputed so the disabled path allocates nothing.
        self.metric = metric
        self._m_hit = metric + ".hit"
        self._m_miss = metric + ".miss"
        self._m_evict = metric + ".eviction"
        self._lock = threading.Lock()
        self._entries: OrderedDict[str, Any] = OrderedDict()  #: guarded by self._lock
        self._bytes = 0  #: guarded by self._lock
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @staticmethod
    def _weight(value: Any) -> int:
        if isinstance(value, torch.Tensor):
            return value.numel() * value.element_size()
        if isinstance(value, Mapping):
            # a memoized set of arrays (a serving fleet's built weights):
            # the sum of its values, so it counts against the byte bound
            return sum(HandleCache._weight(v) for v in value.values())
        # mmap views cost address space, not residency: count them light
        if isinstance(value, np.memmap) or (
            isinstance(value, np.ndarray) and isinstance(value.base, np.memmap)
        ):
            return 0
        return int(getattr(value, "nbytes", 0))

    def get(self, path: str | os.PathLike, loader: Callable[[], Any]) -> Any:
        key = str(path)
        with self._lock:
            if key in self._entries:
                self.hits += 1
                self._entries.move_to_end(key)
                obs.add(self._m_hit)
                return self._entries[key]
            self.misses += 1
        obs.add(self._m_miss)
        value = loader()  # outside the lock: loads fault pages, read, decode
        evicted = 0
        with self._lock:
            if key not in self._entries:
                self._entries[key] = value
                self._bytes += self._weight(value)
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity or (
                self._bytes > self.max_bytes and len(self._entries) > 1
            ):
                _, old = self._entries.popitem(last=False)
                self._bytes -= self._weight(old)
                self.evictions += 1
                evicted += 1
        if evicted:
            obs.add(self._m_evict, evicted)
        return value

    def invalidate(self, path: str | os.PathLike | None = None) -> None:
        """Drop one handle (or all): a file was rewritten."""
        with self._lock:
            if path is None:
                self._entries.clear()
                self._bytes = 0
            else:
                old = self._entries.pop(str(path), None)
                if old is not None:
                    self._bytes -= self._weight(old)

    def invalidate_prefix(self, prefix: str | os.PathLike) -> None:
        """Drop every handle under a directory (checkpoint rewritten or
        collected); never a sibling that shares the prefix as a string."""
        prefix = str(prefix)
        with self._lock:
            for key in [k for k in self._entries if _key_under_root(k, prefix)]:
                self._bytes -= self._weight(self._entries.pop(key))

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, path: str | os.PathLike) -> bool:
        with self._lock:
            return str(path) in self._entries


# ---------------------------------------------------------------------------
# Fragment index
# ---------------------------------------------------------------------------


class FragmentIndex:
    """Sorted interval index over one ``(fragment source, param, kind)``.

    Indexes the atom-slices of every available fragment entry (one
    representative writing rank per distinct fragment — replicas hold
    byte-identical data).  ``overlapping(region)`` returns exactly the
    entries that intersect a runtime-coordinate region, found by bisecting
    the dim-0 intervals and exact-checking the remaining dims.
    """

    def __init__(self, source, name: str, kind) -> None:
        manifest = source.manifest
        self.name = name
        self.kind = kind
        self.spec = manifest.params[name]
        self.layout = self.spec.layout_for(kind, manifest.mesh)
        items: list[tuple[int, int, int, Any]] = []
        seen_frags: set[int] = set()
        for rank in source.writing_ranks(name, kind):
            frag = self.layout.fragment_id[rank]
            if frag in seen_frags:
                continue
            seen_frags.add(frag)
            for e in self.layout.entries[rank]:
                if e.atom_slice:
                    a0, a1 = e.atom_slice[0]
                else:  # 0-d tensor: a single degenerate interval
                    a0, a1 = 0, 1
                items.append((a0, a1, rank, e))
        items.sort(key=lambda t: (t[0], t[1]))
        self._items = items
        self._starts = [t[0] for t in items]
        # prefix max of stops: the leftward scan stops as soon as no earlier
        # interval can still reach the query start.
        self._prefix_max_stop: list[int] = []
        m = -1
        for _, a1, _, _ in items:
            m = max(m, a1)
            self._prefix_max_stop.append(m)

    def overlapping(
        self, region: Sequence[slice]
    ) -> list[tuple[int, Any, tuple[tuple[int, int], ...]]]:
        """Entries intersecting ``region`` (unit-step runtime slices), as
        ``(rank, entry, overlaps)`` with the per-dim ``(lo, hi)`` intersection
        in atom coordinates.  Distinct fragments are pairwise disjoint."""
        region = tuple(region)
        if region:
            q_start, q_stop = region[0].start, region[0].stop
        else:
            q_start, q_stop = 0, 1
        out: list[tuple[int, Any, tuple[tuple[int, int], ...]]] = []
        j = bisect.bisect_left(self._starts, q_stop) - 1  # start0 < q_stop
        while j >= 0 and self._prefix_max_stop[j] > q_start:
            a0, a1, rank, e = self._items[j]
            j -= 1
            if a1 <= q_start:
                continue
            ovs: list[tuple[int, int]] = []
            ok = True
            for (f0, f1), r in zip(e.atom_slice, region):
                lo, hi = max(f0, r.start), min(f1, r.stop)
                if hi <= lo:
                    ok = False
                    break
                ovs.append((lo, hi))
            if ok:
                out.append((rank, e, tuple(ovs)))
        return out


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


class CheckpointEngine:
    """Shared I/O engine: fragment indexes + handle cache + worker pool.

    One engine per device (:func:`default_engine`) is normally enough: the
    caches are keyed by checkpoint root, so several checkpoints share it.
    Benchmarks build private engines to compare ``workers=1`` with a wider
    pool under otherwise identical caching.
    """

    def __init__(self, device=None, *, workers: int | None = None) -> None:
        """``device``: where coded shards and atoms decode (a CUDA device:
        the dequantize kernel; anything else: numpy on the host).

        ``workers=1`` is the reference's serial profile: fresh ``np.zeros``
        staging, jobs run inline in order.  ``workers>1`` runs jobs on a
        pool and recycles staging buffers through the arena.  Raw shard and
        atom files are mmap'd under both profiles: a handle costs address
        space, not memory; decoded tensors and arrays are bounded at 1 GiB."""
        device = torch.device(device) if device is not None else None
        self.device = device
        # Coded state decodes on the card only; a CPU engine decodes with numpy.
        self.decode_device = device if device is not None and device.type == "cuda" else None
        self.workers = default_workers() if workers is None else int(workers)
        if self.workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.use_arena = self.workers > 1
        self.handles = HandleCache(1024, 1 << 30)
        # Consolidated atoms of the stream restore: a byte-bounded LRU, so a
        # restore's peak memory for them is capped.
        self.atoms = HandleCache(256, 1 << 30, metric="engine.atom")
        self.arena = BufferArena(1 << 30)
        self._indexes: dict[tuple[str, str, str], FragmentIndex] = {}  #: guarded by self._index_lock
        self._index_lock = threading.Lock()
        self._flight_locks: dict[str, threading.Lock] = {}  #: guarded by self._flight_locks_lock
        self._flight_locks_lock = threading.Lock()
        self._pool: ThreadPoolExecutor | None = None  #: guarded by self._pool_lock
        self._pool_lock = threading.Lock()

    # ----------------------------------------------------------------- arena
    def alloc(self, shape, dtype, *, zero: bool = True) -> np.ndarray:
        """Host staging buffer: arena-backed, or a plain fresh ``np.zeros``
        under the serial profile."""
        if not self.use_arena:
            return np.zeros(tuple(int(s) for s in shape), _np_dtype(dtype))
        return self.arena.alloc(shape, dtype, zero=zero)

    def recycle(self, arr) -> None:
        if self.use_arena:
            self.arena.recycle(arr)

    # ------------------------------------------------------------------ pool
    def _get_pool(self) -> ThreadPoolExecutor:
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.workers, thread_name_prefix="ckpt-io"
                )
            return self._pool

    def map(self, fn: Callable[[Any], Any], items: Iterable[Any]) -> list[Any]:
        """Run ``fn`` over ``items``; results in order.

        ``workers == 1`` runs inline in iteration order — the serial path
        itself, not a one-thread pool.  A job running in this engine's pool
        must never call ``map`` on the same engine (it would wait on the
        pool it occupies)."""
        items = list(items)
        if self.workers == 1 or len(items) <= 1:
            return [fn(x) for x in items]
        parent = obs.current()
        if parent is not None:
            # Explicit span handoff into the pool: worker-side spans nest
            # under the submitting span (which stays open: map() blocks on
            # the results), not as per-thread roots.
            inner = fn

            def fn(x):
                with obs.attach(parent):
                    return inner(x)

        return list(self._get_pool().map(fn, items))

    def close(self) -> None:
        with self._pool_lock:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None
        self.handles.invalidate()
        self.atoms.invalidate()
        self.arena.clear()
        with self._flight_locks_lock:
            self._flight_locks.clear()
        with self._index_lock:
            self._indexes.clear()

    def __enter__(self) -> "CheckpointEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ----------------------------------------------------------------- index
    def index_for(self, source, name: str, kind) -> FragmentIndex:
        """The (cached) fragment index of one ``(source, param, kind)``."""
        key = (source_cache_key(source), name, getattr(kind, "value", str(kind)))
        # Unlocked peek: dict.get is atomic and an index is immutable once
        # inserted, so a stale miss falls through to the locked setdefault.
        idx = self._indexes.get(key)  # repro: allow[lock-discipline] -- GIL-atomic read of an insert-only dict; misses retry under the lock
        if idx is not None:
            obs.add("engine.index.hit")
            return idx
        with obs.span("engine.index_build", param=name):
            obs.add("engine.index.build")
            idx = FragmentIndex(source, name, kind)
        with self._index_lock:
            return self._indexes.setdefault(key, idx)

    # ----------------------------------------------------------------- reads
    def read_shard(self, ckpt, rank: int, name: str, kind):
        """Handle-cached read of one distributed shard file; a coded one is
        decoded (on the engine's card, if it has one) once, however many
        regions and threads ask for it."""
        path = ckpt.shard_path(rank, name, kind)
        return self._single_flight(
            str(path),
            lambda: ckpt.read_shard(rank, name, kind, device=self.decode_device),
            self.handles,
        )

    def read_fragment(self, source, rank: int, name: str, kind):
        """One available fragment of a fragment source, through the handle
        cache when the source reads with an engine."""
        read = getattr(source, "read_fragment", None)
        if read is not None:
            return read(rank, name, kind, engine=self)
        return self.read_shard(source, rank, name, kind)

    def read_atom(self, ucp, name: str, kind):
        """Handle-cached read of one UCP atom file: a restore serving R
        regions of a parameter opens (or decodes) its atom once."""
        path = ucp.atom_path(name, kind)
        return self._single_flight(
            str(path),
            lambda: ucp.read_atom(name, kind, device=self.decode_device),
            self.handles,
        )

    def consolidated(self, source, name: str, kind, build: Callable[[], Any]):
        """Memoized in-memory consolidated atom of one ``(source, param,
        kind)``: built once, then it serves every Target region of the
        parameter.  Single-flight per key, so concurrent region reads of
        one parameter never assemble it twice."""
        key = f"{source_cache_key(source)}::atom::{name}@{getattr(kind, 'value', kind)}"
        if obs.active() is not None:
            return self._single_flight(key, functools.partial(_traced, name, build))
        return self._single_flight(key, build)

    def shared_region(self, source, name: str, kind, region: Sequence[slice], dtype,
                      builder: Callable[[], Any]) -> Any:
        """Memoized region read: the *serving hot set* of fan-out sources.

        A fleet of readers restoring onto one Target layout asks for the
        same ``(source, param, kind, region)`` again and again; a source
        that opts in (``share_regions = True``, e.g.
        :class:`~repro_torch.serve.PeerFragmentSource`) gets each distinct
        region assembled once, single-flight, into the byte-bounded atom
        cache, and served from there to every reader.

        The cached array is shared: consumers treat it as read-only (the
        restore copies out of it).  ``recycle`` of a cached region is safe:
        the arena's reclamation is refcount-gated and the cache entry keeps
        the view chain alive until it is evicted."""
        kv = getattr(kind, "value", kind)
        span = ",".join(f"{r.start}:{r.stop}" for r in region)
        key = (f"{source_cache_key(source)}::region::{name}@{kv}"
               f"::{_np_dtype(dtype).str}::{span}")
        return self._single_flight(key, builder)

    def memo(self, key: str, builder: Callable[[], Any]) -> Any:
        """Single-flight memoization under an explicit key in the atom
        cache: derived values that fit neither the region nor the atom key
        (a serving fleet's built weights, shared by replica threads).  Keys
        start with the owning source's ``cache_key``, so ``invalidate`` of
        that key drops them too.  A mapping of tensors weighs the sum of
        their bytes."""
        return self._single_flight(key, builder)

    def _single_flight(self, key: str, builder: Callable[[], Any],
                       cache: HandleCache | None = None) -> Any:
        with self._flight_locks_lock:
            lock = self._flight_locks.setdefault(key, threading.Lock())
        with lock:
            return (self.atoms if cache is None else cache).get(key, builder)

    def invalidate(self, root: str | os.PathLike | None = None) -> None:
        """Forget cached state: all of it, or one checkpoint root's (its
        handles, atoms, indexes, delta-variant keys).  Call after rewriting
        files in place."""
        if root is None:
            self.handles.invalidate()
            self.atoms.invalidate()
            with self._flight_locks_lock:
                self._flight_locks.clear()
            with self._index_lock:
                self._indexes.clear()
            return
        root = str(root)
        self.handles.invalidate_prefix(root)
        self.atoms.invalidate_prefix(root)
        with self._flight_locks_lock:
            for key in [k for k in self._flight_locks if _key_under_root(k, root)]:
                del self._flight_locks[key]
        with self._index_lock:
            for key in [k for k in self._indexes if _key_under_root(k[0], root)]:
                del self._indexes[key]

    def invalidate_chain(self, ckpt) -> None:
        """Invalidate a checkpoint root and every ancestor directory its
        delta chain references: a reader that failed mid-chain may hold
        stale handles of any link."""
        roots = getattr(ckpt, "chain_roots", None)
        for root in roots() if roots is not None else [ckpt.root]:
            self.invalidate(root)


    def release(self, source) -> None:
        """Drop what this engine cached of one checkpoint, its delta chain
        and its UCP atoms (``<root>.ucp``): the end of a restore or an
        export, so that no decoded shard outlives the read that needed it.
        A source with no root (an in-memory hot snapshot) drops what is
        keyed by its ``cache_key``."""
        if getattr(source, "root", None) is None:
            self.invalidate(source_cache_key(source))
            return
        self.invalidate_chain(source)
        self.invalidate(str(source.root) + ".ucp")


def _traced(name: str, build: Callable[[], Any]) -> Any:
    """Build a consolidated atom inside its ``restore.consolidate`` span."""
    with obs.span("restore.consolidate", param=name):
        return build()


_default_engines: dict[str, CheckpointEngine] = {}  #: guarded by _default_lock
_default_lock = threading.Lock()


def device_key(device) -> str:
    """The key of one engine per device: "cpu", or "cuda:N" with N filled in."""
    if device is None:
        return "cpu"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return str(device)


def default_engine(device=None) -> CheckpointEngine:
    """The process-wide shared engine of ``device`` (lazily created; None
    and ``"cpu"`` are the host engine).  One per device, so decoded card
    tensors and host arrays never share a cache."""
    key = device_key(device)
    with _default_lock:
        eng = _default_engines.get(key)
        if eng is None:
            eng = _default_engines[key] = CheckpointEngine(None if key == "cpu" else key)
        return eng


def default_engines() -> list[CheckpointEngine]:
    """Every default engine created so far (a re-save invalidates them all)."""
    with _default_lock:
        return list(_default_engines.values())

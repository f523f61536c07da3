"""The checkpoint I/O engine, serial (port of ``repro.core.engine``).

The reference engine owns a fragment index, a handle cache, a buffer arena
and a worker pool.  This port keeps what the restore path needs to give the
same bytes: :class:`FragmentIndex` (which fragments overlap a region) and a
serial :class:`CheckpointEngine` with cached indexes, fragment reads,
staging allocation (plain numpy or, on a device, torch: with no arena
there is nothing to recycle) and memoized consolidated atoms.  The thread pool, the
handle cache and the arena wait for the parallel-I/O item of the ROADMAP
(queue 1, item 3); the reference's ``workers=1`` profile is exactly this
serial order.

A *fragment source* is anything with a ``.manifest`` (``params``, ``mesh``,
``save_mode``), ``.writing_ranks(name, kind)`` and
``.read_fragment(rank, name, kind, device=)`` — here, a
:class:`~repro_torch.core.dist_ckpt.DistCheckpoint`.

An engine made for a CUDA ``device`` asks for coded fragments decoded there
(the dequantize kernel), and the region reads that use them assemble on the
card; raw fragments stay host numpy
(:func:`~repro_torch.core.tensor_io.staging_like` is that rule).
"""

from __future__ import annotations

import bisect
from typing import Any, Callable, Sequence

import numpy as np
import torch

__all__ = ["CheckpointEngine", "FragmentIndex", "source_cache_key"]


def source_cache_key(source) -> str:
    """Index-cache identity of a source (``cache_key``, else the root path)."""
    key = getattr(source, "cache_key", None)
    return key if key is not None else str(source.root)


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


class CheckpointEngine:
    """Serial I/O engine: cached fragment indexes and consolidated atoms.

    One engine per restore is the normal use: its caches live as long as
    the engine, and a consolidated atom is held until the engine is dropped.
    """

    def __init__(self, device=None) -> None:
        device = torch.device(device) if device is not None else None
        # Coded fragments decode on the card only; a CPU engine decodes with numpy.
        self.decode_device = device if device is not None and device.type == "cuda" else None
        self._indexes: dict[tuple[str, str, str], FragmentIndex] = {}
        self._atoms: dict[str, np.ndarray | torch.Tensor] = {}
        # Fragments decoded on the card for the (source, param, kind) being
        # read: each coded file is decoded once however many Target regions
        # straddle it.  Reset when the next (param, kind) starts.
        self._decoded_for: tuple | None = None
        self._decoded: dict[int, torch.Tensor] = {}

    def index_for(self, source, name: str, kind) -> FragmentIndex:
        """The (cached) fragment index of one ``(source, param, kind)``."""
        key = (source_cache_key(source), name, getattr(kind, "value", str(kind)))
        idx = self._indexes.get(key)
        if idx is None:
            idx = self._indexes[key] = FragmentIndex(source, name, kind)
        return idx

    def read_fragment(self, source, rank: int, name: str, kind):
        """One available fragment of a fragment source (coded ones decoded on
        the engine's card, if it has one, once per param and kind)."""
        key = (source_cache_key(source), name, getattr(kind, "value", kind))
        if key != self._decoded_for:
            self._decoded_for, self._decoded = key, {}
        frag = self._decoded.get(rank)
        if frag is None:
            frag = source.read_fragment(rank, name, kind, device=self.decode_device)
            if isinstance(frag, torch.Tensor) and frag.is_cuda:
                self._decoded[rank] = frag
        return frag

    def consolidated(self, source, name: str, kind, make: Callable[[], Any]):
        """Memoized in-memory consolidated atom of one ``(source, param, kind)``:
        built once, then it serves every Target region of the parameter."""
        key = f"{source_cache_key(source)}::atom::{name}@{getattr(kind, 'value', kind)}"
        atom = self._atoms.get(key)
        if atom is None:
            atom = self._atoms[key] = make()
        return atom

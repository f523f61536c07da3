"""Pure-math shard layout: the geometry underneath Universal Checkpointing.

This module answers, *without touching any device*, the question:

    "Given a global tensor, a mesh, and a PartitionSpec-style sharding,
     which byte ranges of the consolidated (atom) tensor does logical
     rank ``r`` own, and where do they sit inside its local shard?"

Everything else in ``repro_torch.core`` (Extract / Union / StripPadding /
GenUcpMetadata / Load) is built on the index maps produced here.  Keeping
this layer device-free is the JAX analogue of the paper's observation that
checkpoint transformation is an *offline* operation: conversion between a
Source and a Target parallelism never needs the Source or Target hardware.

Semantics mirror JAX's ``NamedSharding``, so checkpoints written by the
JAX package and by this port address the same bytes:

* a dimension sharded over mesh axes ``(a, b)`` is split into
  ``size(a) * size(b)`` equal chunks, with axis ``a`` major;
* non-divisible dimensions use ceil-division with trailing padding
  (GSPMD behaviour) — the padded region is what the paper's
  ``StripPadding`` operator removes;
* ranks are row-major over the mesh axes in declaration order
  (``mesh.devices.flat`` ordering).

On top of the NamedSharding semantics we add two things NamedSharding does
not model, both needed for checkpoint reconfiguration:

* **sub-fragments** (paper Fig. 5): a fused dimension (e.g. packed QKV of a
  GQA block, with differently-sized Q/K/V regions) whose parts are sharded
  *independently*; the local shard is the concatenation of the per-part
  slices, so a rank's data is not one contiguous slice of the atom tensor;
* **stacked-dim stage partitioning**: layer-stacked parameters ``[L, ...]``
  split contiguously along ``L`` into pipeline stages (``unique_params``
  w.r.t. other stages).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import numpy as np
import torch

__all__ = [
    "MeshSpec",
    "DimSpec",
    "SubFragment",
    "IndexEntry",
    "ShardLayout",
    "compute_layout",
    "slice_shard",
]


# ---------------------------------------------------------------------------
# Mesh description (no devices)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A logical device mesh: ordered named axes with sizes.

    ``MeshSpec`` is deliberately a *description*: it is built from a dict
    (``MeshSpec.from_dict``, what ``--mesh data=2,model=2`` parses to) or
    from a manifest, on a machine with a single device.
    """

    axes: tuple[tuple[str, int], ...]

    def __post_init__(self) -> None:
        names = [a for a, _ in self.axes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate mesh axis names: {names}")
        for name, size in self.axes:
            if size < 1:
                raise ValueError(f"mesh axis {name!r} has non-positive size {size}")

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_dict(cls, d: Mapping[str, int]) -> "MeshSpec":
        return cls(tuple(d.items()))

    # -- basic queries -----------------------------------------------------

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(a for a, _ in self.axes)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(s for _, s in self.axes)

    @property
    def size(self) -> int:
        return math.prod(self.shape) if self.axes else 1

    def axis_size(self, name: str) -> int:
        for a, s in self.axes:
            if a == name:
                return s
        raise KeyError(f"no mesh axis named {name!r} in {self.axis_names}")

    def has_axis(self, name: str) -> bool:
        return any(a == name for a, _ in self.axes)

    # -- rank <-> coordinate maps -------------------------------------------

    def coords(self, rank: int) -> dict[str, int]:
        """Row-major rank → per-axis coordinates."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} out of range for mesh of size {self.size}")
        out: dict[str, int] = {}
        rem = rank
        for name, size in reversed(self.axes):
            out[name] = rem % size
            rem //= size
        return out

    def rank_of(self, coords: Mapping[str, int]) -> int:
        rank = 0
        for name, size in self.axes:
            c = coords[name]
            if not 0 <= c < size:
                raise ValueError(f"coord {c} out of range for axis {name!r}")
            rank = rank * size + c
        return rank

    def ranks(self) -> range:
        return range(self.size)

    # -- serialization -----------------------------------------------------

    def to_json(self) -> dict:
        return {"axes": [[a, s] for a, s in self.axes]}

    @classmethod
    def from_json(cls, d: Mapping) -> "MeshSpec":
        return cls(tuple((a, int(s)) for a, s in d["axes"]))


# ---------------------------------------------------------------------------
# Per-dimension sharding description
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SubFragment:
    """One independently-sharded part of a fused dimension (paper Fig. 5).

    ``size`` is the logical length of this part along the fused dimension.
    A packed GQA attention projection ``[q_size + k_size + v_size, hidden]``
    has three sub-fragments of sizes ``q_size``, ``k_size``, ``v_size``.
    """

    name: str
    size: int

    def to_json(self) -> dict:
        return {"name": self.name, "size": self.size}

    @classmethod
    def from_json(cls, d: Mapping) -> "SubFragment":
        return cls(str(d["name"]), int(d["size"]))


@dataclasses.dataclass(frozen=True)
class DimSpec:
    """Sharding of one tensor dimension.

    ``axes``       mesh axes sharding this dim (major→minor; empty = replicated)
    ``parts``      sub-fragments along this dim (None = single homogeneous part)
    """

    axes: tuple[str, ...] = ()
    parts: tuple[SubFragment, ...] | None = None

    def num_shards(self, mesh: MeshSpec) -> int:
        n = 1
        for a in self.axes:
            n *= mesh.axis_size(a)
        return n

    def to_json(self) -> dict:
        return {
            "axes": list(self.axes),
            "parts": None if self.parts is None else [p.to_json() for p in self.parts],
        }

    @classmethod
    def from_json(cls, d: Mapping) -> "DimSpec":
        parts = d.get("parts")
        return cls(
            tuple(d.get("axes", ())),
            None if parts is None else tuple(SubFragment.from_json(p) for p in parts),
        )


# ---------------------------------------------------------------------------
# Index entries: the atom <-> shard correspondence
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class IndexEntry:
    """One rectangular correspondence between the atom tensor and a shard.

    ``atom_slice``   index into the *logical* consolidated tensor
    ``shard_slice``  index into the rank's local (possibly padded) shard

    Both are tuples of ``(start, stop)`` pairs, one per dimension.  Regions
    of the local shard not covered by any entry are alignment padding
    (zero-filled on Load; dropped by Union — this is ``StripPadding``).
    """

    atom_slice: tuple[tuple[int, int], ...]
    shard_slice: tuple[tuple[int, int], ...]

    def atom_index(self) -> tuple[slice, ...]:
        return tuple(slice(a, b) for a, b in self.atom_slice)

    def shard_index(self) -> tuple[slice, ...]:
        return tuple(slice(a, b) for a, b in self.shard_slice)


# Per-dimension piece: (atom_start, atom_stop, shard_start, shard_stop)
_DimPieces = list[tuple[int, int, int, int]]


def _dim_pieces(
    dim_size: int, dim: DimSpec, mesh: MeshSpec, shard_coord: int
) -> tuple[_DimPieces, int]:
    """Pieces of one dimension owned by shard ``shard_coord``.

    Returns ``(pieces, local_size)`` where each piece maps an atom range to a
    local-shard range along this dimension.  Handles three cases:

    * unsharded dim: one piece covering everything;
    * plain sharded dim: ceil-division chunk (possibly clipped / empty);
    * sub-fragmented dim: one piece per part, each part independently
      ceil-divided, local layout = concatenation of per-part chunks.
    """
    n = dim.num_shards(mesh)
    if dim.parts is None:
        chunk = -(-dim_size // n)  # ceil division (GSPMD)
        local_size = chunk
        a0 = shard_coord * chunk
        a1 = min(a0 + chunk, dim_size)
        if a1 <= a0:
            return [], local_size
        return [(a0, a1, 0, a1 - a0)], local_size

    # Sub-fragmented dim: parts sharded independently.
    if sum(p.size for p in dim.parts) != dim_size:
        raise ValueError(
            f"sub-fragments sum to {sum(p.size for p in dim.parts)}, "
            f"dim size is {dim_size}"
        )
    pieces: _DimPieces = []
    atom_off = 0
    local_off = 0
    for part in dim.parts:
        chunk = -(-part.size // n)
        a0 = atom_off + shard_coord * chunk
        a1 = min(a0 + chunk, atom_off + part.size)
        if a1 > a0:
            pieces.append((a0, a1, local_off, local_off + (a1 - a0)))
        atom_off += part.size
        local_off += chunk
    return pieces, local_off


def _shard_coord(dim: DimSpec, mesh: MeshSpec, coords: Mapping[str, int]) -> int:
    """Mixed-radix shard coordinate along one dim (first axis is major)."""
    c = 0
    for a in dim.axes:
        c = c * mesh.axis_size(a) + coords[a]
    return c


# ---------------------------------------------------------------------------
# Full layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """Complete layout of one tensor over one mesh.

    ``entries[rank]``       index entries for that rank (may be empty)
    ``local_shape``         shape of every rank's local shard (uniform)
    ``fragment_id[rank]``   ranks with equal fragment_id hold byte-identical
                            data — the replication structure that lets Union
                            read one rank per fragment and lets the saver
                            dedup replicas.
    """

    global_shape: tuple[int, ...]
    dims: tuple[DimSpec, ...]
    mesh: MeshSpec
    entries: tuple[tuple[IndexEntry, ...], ...]
    local_shape: tuple[int, ...]
    fragment_id: tuple[int, ...]

    def primary_ranks(self) -> list[int]:
        """One representative rank per distinct fragment (lowest rank wins)."""
        seen: dict[int, int] = {}
        for r, f in enumerate(self.fragment_id):
            seen.setdefault(f, r)
        return [seen[f] for f in sorted(seen)]


def compute_layout(
    global_shape: Sequence[int],
    dims: Sequence[DimSpec],
    mesh: MeshSpec,
) -> ShardLayout:
    """Compute the full atom↔shard correspondence for one tensor.

    This is the engine behind both checkpoint *saving* (what does rank r
    write?) and the paper's ``Union`` / ``GenUcpMetadata`` / ``Load``
    operators (where do rank r's bytes land in the atom, and vice versa).
    """
    global_shape = tuple(int(s) for s in global_shape)
    dims = tuple(dims)
    if len(dims) != len(global_shape):
        raise ValueError(
            f"got {len(dims)} dim specs for tensor of rank {len(global_shape)}"
        )
    used: set[str] = set()
    for d in dims:
        for a in d.axes:
            if a in used:
                raise ValueError(f"mesh axis {a!r} used on more than one dim")
            if not mesh.has_axis(a):
                raise ValueError(f"unknown mesh axis {a!r}")
            used.add(a)

    # Local shard shape is rank-independent.
    local_shape: list[int] = []
    for size, d in zip(global_shape, dims):
        if d.parts is None:
            local_shape.append(-(-size // d.num_shards(mesh)))
        else:
            n = d.num_shards(mesh)
            local_shape.append(sum(-(-p.size // n) for p in d.parts))

    entries_per_rank: list[tuple[IndexEntry, ...]] = []
    frag_key_to_id: dict[tuple[int, ...], int] = {}
    fragment_id: list[int] = []
    for rank in mesh.ranks():
        coords = mesh.coords(rank)
        shard_coords = tuple(_shard_coord(d, mesh, coords) for d in dims)
        frag = frag_key_to_id.setdefault(shard_coords, len(frag_key_to_id))
        fragment_id.append(frag)

        per_dim: list[_DimPieces] = []
        empty = False
        for size, d, sc in zip(global_shape, dims, shard_coords):
            pieces, _ = _dim_pieces(size, d, mesh, sc)
            if not pieces:
                empty = True
                break
            per_dim.append(pieces)
        if empty:
            entries_per_rank.append(())
            continue

        # Cartesian product of per-dim pieces → rectangular entries.
        rank_entries: list[IndexEntry] = []
        idx = [0] * len(per_dim)
        while True:
            atom_sl = []
            shard_sl = []
            for dpieces, i in zip(per_dim, idx):
                a0, a1, l0, l1 = dpieces[i]
                atom_sl.append((a0, a1))
                shard_sl.append((l0, l1))
            rank_entries.append(IndexEntry(tuple(atom_sl), tuple(shard_sl)))
            # advance mixed-radix counter
            for k in reversed(range(len(per_dim))):
                idx[k] += 1
                if idx[k] < len(per_dim[k]):
                    break
                idx[k] = 0
            else:
                break
            if all(i == 0 for i in idx):
                break
        entries_per_rank.append(tuple(rank_entries))

    return ShardLayout(
        global_shape=global_shape,
        dims=dims,
        mesh=mesh,
        entries=tuple(entries_per_rank),
        local_shape=tuple(local_shape),
        fragment_id=tuple(fragment_id),
    )


# ---------------------------------------------------------------------------
# Array-level helpers shared by saver / ops
# ---------------------------------------------------------------------------


def slice_shard(global_arr, layout: ShardLayout, rank: int):
    """Materialize rank's local shard (with zero padding) from a global array.

    ``global_arr`` is a numpy array or a torch tensor; a tensor's shard is
    allocated on its device, through the same ``entries[rank]`` index maps."""
    if isinstance(global_arr, torch.Tensor):
        local = torch.zeros(layout.local_shape, dtype=global_arr.dtype, device=global_arr.device)
    else:
        local = np.zeros(layout.local_shape, dtype=global_arr.dtype)
    for e in layout.entries[rank]:
        local[e.shard_index()] = global_arr[e.atom_index()]
    return local

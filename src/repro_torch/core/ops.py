"""The UCP transformation operators (paper §3.2, Table 2), port of
``repro.core.ops``.

=========================== ==================================================
``extract``                  enumerate the parameter states of a distributed
                             checkpoint, per owning rank (lazy / mmap)
``union``                    consolidate one parameter's fragments into its
                             atom (Algorithm 1)
``strip_padding``            remove alignment padding (runtime → logical) and
                             collapse the replica dim of ``params_to_average``
``gen_ucp_metadata``         the Target-side fragment geometry (``LoadPlan``)
``load_param_shard``         one Target rank's local shard from atoms, reading
                             only the regions it owns (mmap slices)
``clip_region_to_logical``   the canonical-padding rule of every load path
``read_runtime_region``      serve a runtime-coordinate region from an atom
=========================== ==================================================

Numpy, as in the reference; an atom that is a torch tensor (coded moments
decoded on the card, or a bf16/fp8 state, which numpy cannot hold) stays a
tensor on its device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Mapping, Sequence

import numpy as np
import torch

from .atoms import AtomInfo, UcpCheckpoint
from .layout import IndexEntry, MeshSpec, ShardLayout
from .patterns import STATE_KINDS, ParamSpec, StateKind
from .tensor_io import staging_like, to_staging, torch_dtype

__all__ = [
    "extract",
    "union",
    "load_param_shard",
    "Fragment",
    "strip_padding",
    "clip_region_to_logical",
    "read_runtime_region",
    "gen_ucp_metadata",
    "LoadPlan",
    "ParamLoadPlan",
]


@dataclasses.dataclass(frozen=True)
class Fragment:
    """One rank's persisted piece of one parameter state."""

    name: str
    kind: StateKind
    rank: int
    layout: ShardLayout
    shard: np.ndarray  # usually an mmap view


def extract(
    ckpt,
    names: Sequence[str] | None = None,
    kinds: Sequence[StateKind] = STATE_KINDS,
) -> Iterator[Fragment]:
    """Enumerate persisted fragments of a distributed checkpoint.

    The on-disk format already stores one file per (rank, param, kind), so
    Extract is an enumeration rather than a physical split."""
    manifest = ckpt.manifest
    for name in names if names is not None else sorted(manifest.params):
        for kind in kinds:
            if kind not in manifest.params[name].states:
                continue
            for rank, layout, shard in ckpt.iter_param_fragments(name, kind):
                yield Fragment(name, kind, rank, layout, shard)


def union(ckpt, spec: ParamSpec, kind: StateKind, *, out=None, engine=None):
    """Consolidate one parameter state into its (logical) atom: delegates
    to :func:`repro_torch.core.convert.assemble_atom`, the kernel the UCP
    export and the stream restore share."""
    from .convert import assemble_atom  # deferred: convert imports this module

    return assemble_atom(ckpt, spec, kind, out=out, engine=engine)


def strip_padding(runtime_atom: np.ndarray, spec: ParamSpec) -> np.ndarray:
    """Runtime-shaped consolidated tensor → logical atom.

    Crops per-dim alignment padding; for ``params_to_average`` averages the
    leading replica dim (Algorithm 1: ``Sum(fp_1..fp_n)/n``).
    """
    crop = tuple(slice(0, s) for s in spec.logical_shape)
    if spec.average and isinstance(runtime_atom, torch.Tensor):
        return runtime_atom.to(torch.float64).mean(dim=0)[crop].to(runtime_atom.dtype)
    if spec.average:
        body = runtime_atom.astype(np.float64).mean(axis=0)
        return body[crop].astype(runtime_atom.dtype)
    return runtime_atom[crop]


@dataclasses.dataclass(frozen=True)
class ParamLoadPlan:
    """Target-side geometry of one parameter state (paper: GenUcpMetadata).

    ``read_bytes(rank)`` is the exact I/O the rank performs: UCP Load is
    proportional to the Target partition, not the model."""

    name: str
    kind: StateKind
    spec: ParamSpec
    layout: ShardLayout
    target_dtype: str

    def read_bytes(self, rank: int) -> int:
        item = torch.empty(0, dtype=torch_dtype(self.target_dtype)).element_size()
        total = 0
        for e in self.layout.entries[rank]:
            region = _clip_to_logical(e, self.spec)
            if region is not None:
                total += math.prod(b - a for a, b in region[0]) * item
        return total


@dataclasses.dataclass(frozen=True)
class LoadPlan:
    mesh: MeshSpec
    params: dict[str, dict[StateKind, ParamLoadPlan]]

    def total_read_bytes(self, rank: int) -> int:
        return sum(p.read_bytes(rank) for kinds in self.params.values() for p in kinds.values())


def gen_ucp_metadata(
    target_params: Mapping[str, ParamSpec],
    target_mesh: MeshSpec,
    atoms: Mapping[str, AtomInfo] | None = None,
) -> LoadPlan:
    """Partition metadata for every (param, kind) on the Target.

    With ``atoms`` (a UCP manifest's index) the Target specs are validated
    against it: the logical shapes must agree — mesh, padding, fusion and
    precision may all differ."""
    for name, spec in target_params.items() if atoms is not None else ():
        if name not in atoms:
            raise KeyError(f"target parameter {name!r} has no atom in checkpoint")
        if tuple(atoms[name].logical_shape) != tuple(spec.logical_shape):
            raise ValueError(
                f"{name}: atom logical shape {atoms[name].logical_shape} != "
                f"target logical shape {spec.logical_shape}"
            )
    return LoadPlan(
        mesh=target_mesh,
        params={
            name: {
                kind: ParamLoadPlan(
                    name=name,
                    kind=kind,
                    spec=spec,
                    layout=spec.layout_for(kind, target_mesh),
                    target_dtype=st.dtype,
                )
                for kind, st in spec.states.items()
            }
            for name, spec in target_params.items()
        },
    )


def _clip_to_logical(
    entry: IndexEntry, spec: ParamSpec
) -> tuple[tuple[tuple[int, int], ...], tuple[tuple[int, int], ...]] | None:
    """Clip a runtime-coordinate entry to the atom's logical region.

    Returns ``(atom_region, shard_region)`` — the logical-tensor region to
    read and where it lands in the local shard — or None when the entry lies
    entirely in padding.  For average params the leading replica dim is
    dropped on the atom side (broadcast on load)."""
    atom_sl = entry.atom_slice[1:] if spec.average else entry.atom_slice
    body_shard = entry.shard_slice[1:] if spec.average else entry.shard_slice
    a_out: list[tuple[int, int]] = []
    s_out: list[tuple[int, int]] = []
    for (a0, a1), (s0, _), lim in zip(atom_sl, body_shard, spec.logical_shape):
        c1 = min(a1, lim)
        if c1 <= a0:
            return None
        a_out.append((a0, c1))
        s_out.append((s0, s0 + (c1 - a0)))
    if spec.average:
        # every replica row of the shard receives the same logical data
        s_out.insert(0, entry.shard_slice[0])
    return tuple(a_out), tuple(s_out)


def clip_region_to_logical(
    region: Sequence[slice], logical_shape: Sequence[int]
) -> tuple[tuple[slice, ...], tuple[slice, ...], bool] | None:
    """Clip a canonical runtime-coordinate region to the logical tensor.

    Alignment padding beyond ``logical_shape`` is zero-filled, never served
    from stored bytes.  Returns ``(reads, dests, full)`` — the in-logical
    sub-region to read, where it lands in the output, and whether it covers
    the whole region — or None when the region lies entirely in padding.
    """
    reads: list[slice] = []
    dests: list[slice] = []
    full = True
    for r, lim in zip(region, logical_shape):
        hi = min(r.stop, lim)
        if hi <= r.start:
            return None
        if hi < r.stop:
            full = False
        reads.append(slice(r.start, hi))
        dests.append(slice(0, hi - r.start))
    return tuple(reads), tuple(dests), full


def read_runtime_region(atom, spec: ParamSpec, region: tuple[slice, ...], dtype, *, alloc=None):
    """Read a runtime-coordinate region from a logical atom (numpy, or a
    tensor whose device the region stays on), zero-filling alignment
    padding and broadcasting the replica dim of ``params_to_average``
    parameters.

    ``alloc``: optional ``(shape, dtype, zero=...) -> ndarray`` allocator
    of a host region (the engine's buffer arena); ``zero=False`` is asked
    for when the atom covers the whole region."""
    rt = spec.runtime_shape
    region = tuple(slice(*r.indices(s)) for r, s in zip(region, rt))
    shape = tuple(r.stop - r.start for r in region)
    body = region[1:] if spec.average else region
    clipped = clip_region_to_logical(body, spec.logical_shape)
    if clipped is None:  # region entirely inside padding
        return staging_like([atom], shape, dtype, zero=True, alloc=alloc)
    reads, dests, full = clipped
    out = staging_like([atom], shape, dtype, zero=not full, alloc=alloc)
    piece = to_staging(out, atom[reads])
    if spec.average:
        out[(slice(None), *dests)] = piece[None]
    else:
        out[dests] = piece
    return out


def load_param_shard(
    ucp: UcpCheckpoint, plan: ParamLoadPlan, rank: int, *, atom=None, device=None
):
    """Materialize one Target rank's local shard of one parameter state.

    Reads only the atom regions the rank owns; fills alignment padding with
    zeros; broadcasts averaged atoms across the Target's replica dim; casts
    to the Target precision policy (fp32 atoms → a bf16 Target, etc.).  A
    numpy array for numpy dtypes, else a tensor (on ``device``, or the
    atom's)."""
    spec = plan.spec
    if atom is None:
        atom = ucp.read_atom(plan.name, plan.kind, device=device)
    local = staging_like([atom], plan.layout.local_shape, plan.target_dtype, zero=True)
    for e in plan.layout.entries[rank]:
        clipped = _clip_to_logical(e, spec)
        if clipped is None:
            continue
        atom_region, shard_region = clipped
        piece = atom[tuple(slice(a, b) for a, b in atom_region)]
        dst = tuple(slice(a, b) for a, b in shard_region)
        if isinstance(local, torch.Tensor):
            piece = piece if isinstance(piece, torch.Tensor) else torch.from_numpy(np.array(piece))
            local[dst] = piece.to(local.device, local.dtype).expand(local[dst].shape)
        elif spec.average:
            local[dst] = np.broadcast_to(
                piece.astype(local.dtype), tuple(b - a for a, b in shard_region)
            )
        else:
            local[dst] = piece.astype(local.dtype)
    return local
